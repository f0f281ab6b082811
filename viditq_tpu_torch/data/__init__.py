"""Data loading (port of `viditq_tpu/data/`): the resumable index sampler
and the batching around it."""
