"""The PTQD pair as written (`configs/opensora/w6a6_ptqd.yaml`,
`w8a8_ptqd.yaml`: static per-tensor asym acts, `mixed_precision: [4, 6,
8]` with no bitwidth file) on the tiny STDiT against the JAX package:
`run_ptq`'s tables, a forward, a 2-step CFG DDIM, then `calibrate-ptqd-k`
through `cli.main` on the port's fp and quantized outputs along its fp
trajectory against JAX's `calibrate_ptqd_k` on JAX's
(`tests/test_torch_plans_rest.py` holds the shared set-up)."""

import pytest

from test_torch_plans_rest import (denoise_case, forward_case,  # noqa: F401
                                   plan_pair, ptqd_case, trajectories)

KEYS = ["w6a6_ptqd", "w8a8_ptqd"]


@pytest.mark.parametrize("key", KEYS)
def test_plan_forward_matches_jax(key, plan_pair):
    forward_case(key, plan_pair)


@pytest.mark.parametrize("key", KEYS)
def test_plan_denoise_matches_jax(key, plan_pair):
    denoise_case(key, plan_pair)


@pytest.mark.parametrize("key", KEYS)
def test_ptqd_k_from_the_ports_trajectories_matches_jax(key, plan_pair,
                                                        trajectories,
                                                        tmp_path):
    print(f"{key}: 1 + k_t relative distance to JAX's "
          f"{ptqd_case(key, plan_pair, trajectories, tmp_path):.3g}")
