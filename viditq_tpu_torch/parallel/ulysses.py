"""Ulysses sequence-parallel attention: all-to-all head scatter (port of
`viditq_tpu/parallel/ulysses.py`; reference `SeqParallelAttention`,
`t2v/opensora/models/layers/blocks.py:198-274`).

q/k/v [B, N, H, D] arrive whole on every rank (the JAX model computes its
linears replicated; only the attention runs inside `shard_map`). Each rank
takes its N/sp slice, an all-to-all turns the sequence shards into head
shards [B, N, H/sp, D] (ulysses.py:31-36), `attention_bnhd` runs on them
(on the card K3's full mode, or K6 past its one-shot kv range: the entry
the single-device path uses), and the reverse all-to-all gives each rank
its sequence slice of every head back (:49-50). `gather_batch` over sp
then joins the slices, so the caller sees the whole output, as JAX's
`sp_gather` leaves it replicated (:84-88). JAX's `attention_ok` TPU shape
gate, and the XLA attention it falls back to, have no counterpart: the
port always runs its kernel's numerics. Forward only: the port trains
without sp (the model of the `train` command carries no sp mesh, as in
JAX).
"""

from __future__ import annotations

from typing import Optional

import torch

from viditq_tpu_torch.kernels.attention import attention_bnhd
from viditq_tpu_torch.parallel import comm
from viditq_tpu_torch.parallel.mesh import Mesh, batch_slice, gather_batch


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, scale: Optional[float] = None
                      ) -> torch.Tensor:
    """q, k, v: [B, N, H, D] whole on every rank of the sp axis; H and N
    must divide by its size (ulysses.py:55-71). Returns [B, N, H, D]
    whole."""
    sp = mesh.shape["sp"]
    B, N, H, D = q.shape
    if H % sp:
        raise ValueError(f"heads {H} not divisible by sp={sp}")
    if N % sp:
        raise ValueError(f"sequence {N} not divisible by sp={sp}")
    scale = D ** -0.5 if scale is None else scale
    group = mesh.group("sp")
    # this rank's N/sp slice (JAX `sp_split`, ulysses.py:74-81); scatter
    # heads (dim 2), gather the sequence (dim 1)
    ql, kl, vl = (comm.all_to_all(batch_slice(t, mesh, "sp", 1), group, 2, 1)
                  for t in (q, k, v))
    out = attention_bnhd(ql, kl, vl, scale=scale)  # [B, N, H/sp, D]
    out = comm.all_to_all(out, group, 1, 2)  # [B, N/sp, H, D]
    return gather_batch(out, mesh, "sp", 1)  # JAX `sp_gather` (:84-88)
