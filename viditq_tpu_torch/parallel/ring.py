"""Ring attention over the sp axis (port of `viditq_tpu/parallel/ring.py`).

Each rank keeps its N/sp slice of q; the k and v slices move one rank
along the ring a step (JAX's `ppermute` with perm d -> d + 1, ring.py:45,
:58-60), S - 1 hops, none after the last step, and the softmax runs
online in float32 exactly as ring.py:47-57 writes it:
  m'  = max(m, rowmax(s_j)),  c = exp(m - m'),
  o   = o * c + exp(s_j - m') @ v_j,  r = r * c + rowsum(exp(s_j - m')),
out = o / r in q's dtype. JAX runs this in plain `jnp` outside any Pallas
kernel, so its port is plain PyTorch `einsum`s on the card too. q/k/v
arrive whole and the output leaves whole (gathered over sp), as in
`ulysses_attention`. Any head count works; N must divide by S (:76).
"""

from __future__ import annotations

from typing import Optional

import torch

from viditq_tpu_torch.parallel import comm
from viditq_tpu_torch.parallel.mesh import Mesh, batch_slice, gather_batch


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """q, k, v: [B, N, H, D] whole on every rank of the sp axis. Returns
    [B, N, H, D] whole."""
    S = mesh.shape["sp"]
    B, N, H, D = q.shape
    if N % S:
        raise ValueError(f"sequence {N} not divisible by sp={S}")
    scale = D ** -0.5 if scale is None else scale
    group, ranks = mesh.group("sp"), list(mesh.ranks["sp"])
    ql, kb, vb = (batch_slice(t, mesh, "sp", 1) for t in (q, k, v))
    qf = ql.float() * scale
    n_loc = ql.shape[1]
    o = torch.zeros((B, n_loc, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, n_loc, H, 1), float("-inf"), device=q.device)
    r = torch.zeros((B, n_loc, H, 1), dtype=torch.float32, device=q.device)
    for i in range(S):
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kb.float())
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        c = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        o = o * c + torch.einsum("bqhk,bkhd->bqhd", e, vb.float())
        r = r * c + e.sum(dim=-1, keepdim=True)
        m = m_new
        if i < S - 1:
            kb = comm.shift(kb, group, ranks)
            vb = comm.shift(vb, group, ranks)
    return gather_batch((o / r).to(q.dtype), mesh, "sp", 1)
