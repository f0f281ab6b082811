"""Quantization plan surface, quantizer math, QuantLinear, calibration and packing."""
