"""STDiT's W4A8 plan on the fused kernels as written
(`configs/opensora/w4a8_tpu_fused.yaml`: 4-bit sym per-channel codes in
the int8 range, packed K-major; sym dynamic per-token A8; the int8 PV at
temporal and cross attention; `cfg_split`) on the tiny STDiT against the
JAX package's kernel path in interpret mode: `run_ptq`'s weight tables
(the sym 4-bit table shift, `viditq_tpu/quant/qlinear.py:572-590`, is in
the packed slabs both forwards read), a forward and a 2-step CFG DDIM
(`tests/test_torch_plans_rest.py` holds the shared set-up)."""

import torch

from test_torch_plans_rest import (denoise_case, forward_case,  # noqa: F401
                                   plan_pair, trajectories)
from viditq_tpu_torch.quant.qlinear import QuantLinear


def test_w4a8_fused_forward_matches_jax(plan_pair):
    forward_case("w4a8_tpu_fused", plan_pair)
    # every quantized linear on the native path, its packed codes 4-bit
    # values in the int8 range
    port = plan_pair("w4a8_tpu_fused")[2]
    lins = [m for m in port.modules()
            if isinstance(m, QuantLinear) and m.path is not None]
    assert lins and {m.path for m in lins} == {"native"}
    for m in lins:
        assert m.w_int.dtype == torch.int8
        assert -8 <= int(m.w_int.min()) and int(m.w_int.max()) <= 7


def test_w4a8_fused_denoise_matches_jax(plan_pair):
    denoise_case("w4a8_tpu_fused", plan_pair)
