"""viditq_tpu_torch — the PyTorch/CUDA port of viditq_tpu.

Runs the STDiT-XL/2 W8A8 denoise path on an NVIDIA H100 through
hand-written Hopper kernels (`csrc/`), held against the JAX package
`viditq_tpu` (the reference) by the tests in `tests/test_torch_*.py`.
Imports torch, numpy and yaml; never jax or flax.
"""
