#!/usr/bin/env python3
"""Where the time of one denoise step goes, per slice and arm, on one
NVIDIA H100.

Run from the root of a checkout on a machine with one card:

    python3 chip_profile.py

For each slice of `chip_smoke.py` (STDiT-XL/2 16x512x512 and PixArt-Σ
1024, full width, random weights) and each of its arms (bf16 and sm8 on the
sm8 plan's model; for STDiT also sm8_epi, the sm8 plan with the block's
residual adds in the linears' epilogues (`fuse_epilogue`), attn8
(`w8a8_tpu_fused_attn8.yaml`: int8 q/k and PV at every attention site),
w8a8, the reference W8A8 plan on the
native backend, fused, the same plan through the fused kernels
(`w8a8_tpu_fused.yaml`), and sym (`w8a8_tpu_fused_sym.yaml`), each on its
own model; and cb and cb_sym, ViDiT-Q's W4A8 recipe with timestep-aware
channel balancing on the fused kernels, asym and sym, each calibrated by
one sq_stat forward in each of its timeranges on the profiled inputs;
cb_mp, the cb model with the t20 timestep-wise mixed precision, its union
model's forward at t = 500; the reference plans as written: sim_w8a8 and
sim_w6a6 (`viditq_w{8a8,6a6}.yaml`, simulate), naive (`w8a8_naive.yaml`,
static acts, simulate), naive_fused (its tables on the native backend: K2
on static codes) and hybrid (`w8a8_tpu_hybrid.yaml`); for PixArt-Σ also
cb, its W4A8 plan with CB, calibrated at t = 500, and naive, its
`w8a8_naive.yaml`; each static-act model calibrated by `run_ptq` over the
model's fp trajectory of the first profiled latent, at t = 500 its act
slot) it runs one warm-up CFG step, then one more under `torch.profiler`:
a forward at batch 2, or, for an arm whose plan sets `cfg_split`
(`chip_smoke.arm_sampler`: sim_w8a8 and hybrid), a batch-1 forward on the
cond prompt and one on the null prompt. It prints the host wall time,
the device time (the sum of CUDA kernel time), the device's idle share
(1 - device / wall) and the device time by kernel group and by kernel.
Needs CUDA; builds the kernels as `chip_smoke.py` does.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# kernel-name fragments -> group (first match wins)
GROUPS = (
    # K5's kernel names carry its epilogue's (ZpEpilogue, int8_gemm_epilogue)
    ("dynq_gemm", "K5 quantize-in int8 GEMM"),
    ("attn_stream_kernel", "K6 attention (stream)"),
    ("attn_seg", "K3 attention (seg, temporal)"),
    ("attn_kernel", "K3 attention (one-shot)"),
    ("vquant", "K3/K6 v quantize"),
    ("row_quant_kernel", "K3 emission row quantize"),
    ("int8_gemm", "K2 int8 GEMM"),
    # the zero-point epilogue of int8_mma.cuh is K7b's in the w8a8 arm and
    # K2's under the fused reference plan (its kernel names carry no file)
    ("zpepilogue", "int8 GEMM, zero-point epilogue (K2 fused / K7b w8a8)"),
    ("group_quant", "K2 emission group quantize"),
    ("qk_quant", "K8 q/k headwise quantize"),
    ("ln_mod_quant", "K1 LN+modulate+quantize"),
    ("dyn_quant_rows", "K7a row quantize (native)"),
    ("int8_matmul", "K7b int8 GEMM (native)"),
    ("quant_rows", "K4 row quantize"),
    ("flash", "SDPA (KV-compressed attention)"),
    ("fmha", "SDPA (KV-compressed attention)"),
    ("nvjet", "cuBLAS GEMM"),
    ("gemm", "cuBLAS GEMM"),
    ("xmma", "cuBLAS GEMM"),
    ("cutlass", "cuBLAS GEMM"),
)


def group_of(name: str) -> str:
    low = name.lower()
    for frag, grp in GROUPS:
        if frag in low:
            return grp
    return "PyTorch elementwise / other"


def profile_forward(model, calls, qctx):
    """Profile the model's forwards on each argument tuple of `calls`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        for args in calls:
            model(*args, qctx=qctx)
    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            step()
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
    by_kernel = defaultdict(float)
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0:
            by_kernel[ev.key] += ev.self_device_time_total / 1e3  # us -> ms
    return wall, by_kernel


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from viditq_tpu_torch.kernels import _build
    from viditq_tpu_torch.utils.workload import latent_size
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    _build.lib()
    for name, cfg, n_prompt in (("stdit", cs.STDIT_CFG, 120),
                                ("sigma", cs.SIGMA_CFG, 300)):
        latent = latent_size(cfg)
        rng = np.random.default_rng(0)
        x = torch.tensor(rng.standard_normal((2, 4, *latent)),
                         dtype=torch.bfloat16, device="cuda")
        t = torch.tensor([500.0, 500.0], device="cuda")
        y = torch.tensor(rng.standard_normal((2, 1, n_prompt, 4096)) * 0.1,
                         dtype=torch.bfloat16, device="cuda")
        mask = torch.ones((1, n_prompt), dtype=torch.int32, device="cuda")
        model, model_plan = None, None
        tables = {}
        for arm in cs.SLICE_KERNELS[name]:
            plan = cs.arm_build(name, arm)
            sampler = cs.arm_sampler(name, arm, cfg)
            if plan != model_plan:
                model = None
                torch.cuda.empty_cache()
                model = cs.build_model(cfg, "cuda", plan=plan[0],
                                       recipe=plan[1], calib=(x, y, mask),
                                       model_kw=plan[2],
                                       stat_t=cs.STAT_T[name])
                model_plan = plan
                slot_map = cs.arm_static_setup(name, arm, model, sampler,
                                               x[:1], y, mask, tables)[0]
            runner = model
            if (name, arm) in cs.MP_ARMS:
                runner = cs.mp_report(name, arm, cfg,
                                      cs.quant_plan(*plan[:2]),
                                      sampler, model)[1]
            calls = ([(x[:1], t[:1], y[i:i + 1], mask) for i in (0, 1)]
                     if sampler.cfg_split else [(x, t, y, mask)])
            qctx = cs.qctx_for(arm, 500, slot_map)
            wall, by_kernel = profile_forward(runner, calls, qctx)
            runner = None
            device = sum(by_kernel.values())
            groups = defaultdict(float)
            for k, ms in by_kernel.items():
                groups[group_of(k)] += ms
            print(f"{name} {arm}: one CFG step ({len(calls)} forward"
                  f"{'s' if len(calls) > 1 else ''}), wall {wall:.1f} ms, "
                  f"device {device:.1f} ms, idle share "
                  f"{max(0.0, 1 - device / wall):.3f}", flush=True)
            for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
                print(f"    {ms:9.2f} ms  {grp}")
            print("  top kernels:")
            for k, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
                print(f"    {ms:9.2f} ms  {k[:110]}")
        model = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
