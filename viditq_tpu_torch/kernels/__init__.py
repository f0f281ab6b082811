"""Hand-written kernel wrappers (CUDA sources in ../csrc) and their plain versions."""
