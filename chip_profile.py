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

    python3 chip_profile.py --recon [--package-root DIR]

profiles one iteration of AdaRound block reconstruction instead (the
`ptq` phase of `w4a8_adaround.yaml`, `quant/reconstruction.py`
`block_reconstruction`): block 0 of STDiT-XL/2 (16x512x512) and of
PixArt-Σ 1024, each a one-block model at full width with random weights,
calibrated by `run_ptq` on one step of random inputs (CFG batch 2), its
block captured and copied to float32 as `model_block_reconstruction` does,
then one iteration (forward and backward of the float32 block on both rows,
the Adam step) warmed up and one profiled. It prints the iteration's wall
ms, its device ms and the device ms by group: the float32 attention
forward (K3/K6 float32 kernels), its backward (JAX's custom_vjp: the
plain f32 attention's recompute, timed as a profiler range around
`_AttentionVJP.backward`), the other GEMMs (cuBLAS, TF32 off) and the
rest. --package-root imports `viditq_tpu_torch` from DIR (an unpacked
parent commit, say) so two versions are profiled by the same script.
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


RECON_RANGE = "attention backward (plain f32 recompute)"
GEMM_FRAGMENTS = ("nvjet", "gemm", "xmma", "cutlass")


def range_kernels(prof, label):
    """Device ms by kernel name of the kernels launched under every
    profiler range `label` (its ops' subtrees)."""
    out = defaultdict(float)

    def walk(ev):
        for k in ev.kernels:
            out[k.name] += k.duration / 1e3
        for ch in ev.cpu_children:
            walk(ch)
    for ev in prof.events():
        if ev.name == label:
            walk(ev)
    return out


def recon_main() -> int:
    """One block-reconstruction iteration per slice (module docstring)."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from viditq_tpu_torch.kernels import _build
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.pipelines.ptq import run_ptq
    from viditq_tpu_torch.quant.qlinear import QuantCtx
    from viditq_tpu_torch.quant import reconstruction as recon
    from viditq_tpu_torch.utils import workload
    from viditq_tpu_torch.utils.config import load_quant_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    print(cs.nvidia_smi_line(), flush=True)
    print(f"package: {Path(A.__file__).resolve().parent.parent}", flush=True)
    _build.lib()
    backward = A._AttentionVJP.backward

    def timed_backward(ctx, g):
        with record_function(RECON_RANGE):
            return backward(ctx, g)
    A._AttentionVJP.backward = staticmethod(timed_backward)
    plan = load_quant_config(str(cs.ADAROUND_PLAN))
    one_block = {
        "stdit": (dict(cs.STDIT_CFG, model=dict(
            type="STDiT", depth=1, hidden_size=1152, num_heads=16,
            patch_size=(1, 2, 2))), 120),
        "sigma": (dict(cs.SIGMA_CFG, model=dict(
            type="PixArt", depth=1, hidden_size=1152, num_heads=16,
            patch_size=2, caption_channels=4096, model_max_length=300,
            micro_condition=False)), 300)}
    for name, (cfg, n_prompt) in one_block.items():
        model = workload.build_model(cfg, plan.resolver(), device="cuda")
        workload.random_init_(model, 0, 0.02)
        latent = workload.latent_size(cfg)
        rng = np.random.default_rng(0)
        x = torch.tensor(rng.standard_normal((2, 4, *latent)),
                         dtype=torch.bfloat16, device="cuda")
        t = torch.tensor([500.0, 500.0], device="cuda")
        y = torch.tensor(rng.standard_normal((2, 1, n_prompt, 4096)) * 0.1,
                         dtype=torch.bfloat16, device="cuda")
        mask = torch.ones((1, n_prompt), dtype=torch.int32, device="cuda")
        run_ptq(model, {"xs": x[None], "ts": t[None], "y": y, "mask": mask},
                plan)
        io = recon.capture_block_io(model, (x, t, y, mask))
        x_in, y_out = io["blocks"][0]
        block, extra = model.standalone_block(0)
        rcfg = dataclasses.replace(recon.recon_config(plan), iters=1)
        args = (io["y"], io["t0"], mask.repeat(2, 1))
        qctx = QuantCtx(mode="quant", soft_targets=True)

        def iteration():
            recon.block_reconstruction(block, extra, x_in, y_out, args, rcfg,
                                       qctx, recon.generator(0, 0))
        iteration()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            iteration()
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
        by_kernel = defaultdict(float)
        for ev in prof.key_averages():
            # the range's own device-side annotation spans its kernels
            if (ev.device_type.name == "CUDA" and ev.key != RECON_RANGE
                    and ev.self_device_time_total > 0):
                by_kernel[ev.key] += ev.self_device_time_total / 1e3
        in_bwd = range_kernels(prof, RECON_RANGE)
        groups = defaultdict(float)
        for k, ms in by_kernel.items():
            low = k.lower()
            rest = ms - in_bwd.get(k, 0.0)
            groups["attention backward (plain f32 recompute)"] += (
                in_bwd.get(k, 0.0))
            if "attn" in low and "f32" in low:
                groups["float32 attention forward (K3/K6 float32)"] += rest
            elif any(f in low for f in GEMM_FRAGMENTS):
                groups["other GEMMs (cuBLAS, TF32 off)"] += rest
            else:
                groups["glue (elementwise, reductions, optimizer)"] += rest
        device = sum(by_kernel.values())
        print(f"recon {name} block 0: one iteration, wall {wall:.1f} ms, "
              f"device {device:.1f} ms, idle share "
              f"{max(0.0, 1 - device / wall):.3f}", flush=True)
        for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"    {ms:9.2f} ms  {grp}")
        print("  top kernels:")
        for k, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
            print(f"    {ms:9.2f} ms  {k[:110]}")
        del model, block, io, x_in, y_out
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: CUDA is not available")
    args = sys.argv[1:]
    if "--package-root" in args:
        sys.path.insert(0, args[args.index("--package-root") + 1])
    sys.path.insert(1 if "--package-root" in args else 0, str(ROOT))
    if "--recon" in args:
        return recon_main()
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
