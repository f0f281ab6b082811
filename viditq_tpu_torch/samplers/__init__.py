"""Diffusion schedule, DDIM loop and the IDDPM CFG wrapper."""
