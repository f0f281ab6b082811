"""The port's plan surface, calibration and packing against the JAX
package: every layer name resolves to the same LayerQuantSpec fields, and
the port's calibrate + pack on bridged fp weights gives the JAX package's
int8 codes and column sums exactly and its scales to within an ulp."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import SM8, SYM, build_jax, build_port
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.utils.config import load_quant_config

LAYERS = ["x_embedder.proj", "t_embedder", "t_block", "y_embedder",
          "final_layer.linear"] + [
    f"blocks.{i}.{site}.{lin}" for i in (0, 13, 27)
    for site, lins in (("attn", ("q", "k", "v", "proj")),
                       ("attn_temp", ("q", "k", "v", "proj")),
                       ("cross_attn", ("q_linear", "kv_linear", "proj")),
                       ("mlp", ("fc1", "fc2")))
    for lin in lins]


def _fields(spec):
    return None if spec is None else dataclasses.asdict(spec)


@pytest.mark.parametrize("plan", [SM8, SYM])
def test_plan_resolves_to_the_same_specs(plan):
    jres = j_load(plan).resolver()
    pres = load_quant_config(plan).resolver()
    for name in LAYERS:
        assert _fields(pres(name)) == _fields(jres(name)), name
    # the sm8 softmax scope: int8 PV on the temporal/cross sites only
    if plan == SM8:
        assert pres("blocks.0.attn.q").softmax is None
        assert pres("blocks.0.attn_temp.q").softmax is not None
        assert pres("blocks.0.cross_attn.q_linear").softmax is not None
        assert not pres("final_layer.linear").weight_quant


@pytest.mark.parametrize("plan", [SM8, SYM])
def test_calibrate_and_pack_match_jax(plan):
    _, jv = build_jax(plan)
    port = build_port(plan, jv, fp_only=True)
    calibrate_weight_tables(port)
    pack_native_weights(port)
    sd = port.state_dict()
    n = 0
    for i in range(2):
        for path in ("attn.q", "attn_temp.v", "cross_attn.kv_linear",
                     "mlp.fc1", "mlp.fc2"):
            jq = jv["quant"][f"blocks_{i}"]
            for seg in path.split("."):
                jq = jq[seg]
            name = f"blocks.{i}.{path}"
            np.testing.assert_array_equal(sd[f"{name}.w_int"].numpy(),
                                          jq["w_int"])
            np.testing.assert_array_equal(sd[f"{name}.w_colsum"].numpy(),
                                          jq["w_colsum"])
            # XLA may evaluate absmax / 127 as a multiply by the reciprocal
            np.testing.assert_allclose(sd[f"{name}.w_delta"].numpy(),
                                       jq["w_delta"], rtol=2.5e-7, atol=0)
            np.testing.assert_array_equal(sd[f"{name}.w_zp"].numpy(),
                                          jq["w_zp"])
            n += 1
    assert n == 10
    # every quantized layer got tables; fp layers (remain_fp) have none
    assert "final_layer.linear.w_int" not in sd
    assert all(float(v.min()) > 0 for k, v in sd.items()
               if k.endswith("w_delta"))
    assert all(v.dtype == torch.int8 for k, v in sd.items()
               if k.endswith("w_int"))
