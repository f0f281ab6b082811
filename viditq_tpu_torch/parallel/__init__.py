"""Parallelism and the training steps (port of `viditq_tpu/parallel/`):
the mesh and its collectives over `torch.distributed` (`mesh`, `comm`),
Ulysses and ring sequence-parallel attention (`ulysses`, `ring`), the
GPipe pipeline over the block stack (`pipeline`), and the dp/tp training
step with ZeRO-sharded moments (`training`)."""
