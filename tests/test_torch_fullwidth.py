"""C10's first check: the port against the JAX package at the full width
of STDiT-XL/2 (hidden 1152, 16 heads of 72, mlp 4608), one block, on equal
weights drawn at bench.py's scale (normal x 0.02), under the sm8 plan and
the fused asymmetric plan. The latent (2, 16, 32) gives 256 tokens, which
keeps both JAX kernel gates (the producer's N % 256, the attention's
n % 128); at this width fc1's emission runs in G = 3 groups of 1536
(`emit_groups(4608, 1152)`), which the tiny parity models (G = 1) never
reach, so fc2's group-wise dequant is held against JAX here.

Tolerance: 1e-2 relative for the forward, the sm8 limit
(`tests/test_torch_stdit.py`).
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import (FUSED, SM8, build_jax, build_port, inputs,
                          jax_kernel_path, rel_err)
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.quant.qlinear import QuantCtx

XL = dict(hidden_size=1152, num_heads=16, depth=1)
FWD_TOL = 1e-2


@pytest.mark.parametrize("plan", [SM8, FUSED], ids=["sm8", "fused-asym"])
def test_full_width_block_matches_jax_kernel_path(plan, monkeypatch):
    jmodel, jv = build_jax(plan, weight_scale=0.02, **XL)
    port = build_port(plan, jv, **XL)
    groups = []
    emit = FM.int8_consumer_matmul_plain

    def spy(*a, **kw):
        out = emit(*a, **kw)
        if isinstance(out, tuple):  # the emission: (codes, group scales)
            groups.append(out[1].shape[1])
        return out
    monkeypatch.setattr(FM, "int8_consumer_matmul_plain", spy)
    args = inputs()
    with jax_kernel_path():
        want = np.asarray(jax.jit(lambda x, t, y, m: jmodel.apply(
            jv, x, t, y, m, qctx=JQuantCtx(mode="quant")))(*args))
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.array(a)) for a in args),
                   qctx=QuantCtx(mode="quant")).numpy()
        fp = port(*(torch.from_numpy(np.array(a)) for a in args)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = rel_err(got, want)
    print(f"full width, one block, {plan}: port vs JAX {err:.3g}, port fp "
          f"vs JAX {rel_err(fp, want):.3g}")
    assert err < FWD_TOL
    assert err < 0.75 * rel_err(fp, want)
    # sm8 emits fc1's output in three groups; the asym plan hands it over
    # through K4's GELU pass instead
    assert groups == ([3] if plan == SM8 else [])
