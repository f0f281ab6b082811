"""Training steps (port of `viditq_tpu/parallel/`; the meshes, sequence
and pipeline parallelism are not ported yet)."""
