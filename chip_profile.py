#!/usr/bin/env python3
"""Where the time of one denoise step goes, per slice and arm, on one
NVIDIA H100.

Run from the root of a checkout on a machine with one card:

    python3 chip_profile.py

For each slice of `chip_smoke.py` (STDiT-XL/2 16x512x512, PixArt-Σ
1024, Latte-XL/2 and DiT-XL/2 16x256x256, MMDiT 1024; full width, random
weights; `--slices latte,dit` keeps the ones named) and each of its arms (bf16 and sm8 on the
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
`w8a8_naive.yaml`; Latte's bf16, cb (the W4A8 CB recipe) and cb_mp (its
four-range MP, the union model at t = 500), DiT's bf16 and sm8, MMDiT's
bf16 and w4a8 (`configs/mmdit/w4a8_tpu_fused.yaml`); STDiT's
w4a8_fused (`w4a8_tpu_fused.yaml`) and hybrid_sym, DiT-L/2's bf16 and sm8
(slice `dit_l`), the wide-head slices' bf16 and sm8 (`stdit_h6`:
STDiT-XL/2 in 6 heads of 192; `dit_l_h4`: DiT-L/2 in 4 heads of 256), and
the simulate-backend plan slices at
`chip_smoke.PLAN_DEPTH` blocks (`stdit_plans`, the reference arms above
among them; `alpha`, PixArt-alpha 512; `sigma_plans`), which run only
when `--slices` names them; `--arms a,b` keeps the arms named (an arm
that takes another's model or tables, `MP_ARMS`, `TABLES_FROM`, then
builds its own); each static-act model calibrated by `run_ptq` over the
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

    python3 chip_profile.py --train

profiles one training step instead (`chip_smoke.py` phase train's
`train` command, in process): STDiT-XL/2 16x512x512 with gradient
checkpointing, random weights (normal x 0.02, seed 0), a synthetic batch
of 2, `make_train_step` with AdamW and clipping at 1.0; one step warmed up
and one profiled. It prints the step's wall ms, its device ms, the idle
share and the device ms by group: the forward and the blocks' recompute
(each without K3), K3 (both), the plain attention backward (JAX's
custom_vjp recompute, a profiler range around `_AttentionVJP.backward`),
the rest of the backward, AdamW with clipping, and the EMA (the step's
phases timed by CUDA events between them).

    python3 chip_profile.py --mp-draws

measures, instead of time, how far `quant-generate-mp`'s samples lie from
fp on STDiT-XL/2 16x512x512 (20 DDIM steps, the CLI's seeded weights):
the in-process twins of `chip_smoke.py` phase `cli`'s two MP commands
(`viditq_w4a8.yaml` on the simulate backend with weight tables from the
parameters; `w8a8_naive.yaml` with static act tables from `run_ptq` on
the draw's own fp trajectory), each with the t20 MP configs and without
them (the plan's own bits), on four input draws: the CLI's (its seeded
latent, its N(0, 1) caption embeds), the CLI's with the embeds x 0.1, the
CLI's with the latent x 0.5 and the embeds x 0.1, and `chip_smoke.py`'s
STDiT slice's (`slice_inputs`: latent x 0.5, embeds x 0.1, another seed).
It prints each relative error against fp sampling of the same draw.

    python3 chip_profile.py --slices pixart_alpha

profiles PixArt-α 512 (`configs/workload/pixart_alpha_512.py`: 28 blocks,
C = 1152, 1024 tokens, 120 caption tokens; the CLI's seeded weights,
latent and caption draws) through its samplers instead of one forward:
bf16, and w8a8 (`configs/pixart/w8a8.yaml` on the native backend,
calibrated by `run_ptq` on the bf16 model's multistep trajectory), each on
the multistep DPM-Solver++ (the config's), SA-Solver as the CLI builds it
(eta 0) and SA-Solver with eta 1 (a stochastic step a step: the draws and
their host work). One whole 20-step run each, after a warm-up run: its
wall and device ms per step, idle share and groups, the samplers' host
work (tableaus, the loop's Python) inside the wall.
"""

from __future__ import annotations

import re
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
    ("flash", "SDPA (Σ KV-compressed, MMDiT joint attention)"),
    ("fmha", "SDPA (Σ KV-compressed, MMDiT joint attention)"),
    ("nvjet", "cuBLAS GEMM"),
    ("gemm", "cuBLAS GEMM"),
    ("xmma", "cuBLAS GEMM"),
    ("cutlass", "cuBLAS GEMM"),
)


def group_of(name: str) -> str:
    low = name.lower()
    # the wide heads' kernel (D = 192, 256) is K3's full modes or K6: its
    # third template argument is STREAM
    wide = re.search(r"attn_wide_kernel<\d+, \w+, (\w+)>", low)
    if wide:
        return ("K6 attention (stream)" if wide.group(1) == "true"
                else "K3 attention (one-shot)")
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


def train_main() -> int:
    """One checkpointed STDiT-XL/2 train step by group (module
    docstring). The step's phases (forward, backward, AdamW with clipping,
    EMA) are timed by CUDA events recorded on the stream between them;
    inside the backward the profiler splits out the blocks' recompute and
    the plain attention backward by their ranges, K3 by its kernels'
    names."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    import chip_smoke as cs
    from viditq_tpu_torch.kernels import _build, _counters
    from viditq_tpu_torch.kernels import attention as A
    from viditq_tpu_torch.models import stdit
    from viditq_tpu_torch.parallel import training as tr
    from viditq_tpu_torch.pipelines.train import synthetic_batch
    from viditq_tpu_torch.samplers.gaussian_diffusion import make_schedule
    from viditq_tpu_torch.utils import workload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    _build.lib()
    recompute, attn_bwd = "block recompute", \
        "attention backward (plain recompute)"
    phase, marks = ["fwd"], {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[name] = ev

    def model_forward(fn):
        def run(*a, **k):
            mark("start")
            out = fn(*a, **k)
            mark("forward")
            phase[0] = "bwd"  # what runs blocks next is the recompute
            return out
        return run

    def block_forward(fn):
        def run(*a, **k):
            if phase[0] == "fwd":
                return fn(*a, **k)
            with record_function(recompute):
                return fn(*a, **k)
        return run

    def optimizer_step(fn):
        def run(*a, **k):
            mark("backward")
            out = fn(*a, **k)
            mark("optimizer")
            return out
        return run

    def ema_update(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            mark("ema")
            return out
        return run

    def ranged(fn, label):
        def run(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return run
    A._AttentionVJP.backward = staticmethod(
        ranged(A._AttentionVJP.backward, attn_bwd))
    tr.Optimizer.step = optimizer_step(tr.Optimizer.step)
    tr.update_ema = ema_update(tr.update_ema)
    stdit.STDiT.forward = model_forward(stdit.STDiT.forward)
    stdit.STDiTBlock.forward = block_forward(stdit.STDiTBlock.forward)
    cfg = dict(cs.STDIT_CFG, model=dict(cs.STDIT_CFG["model"],
                                        grad_checkpoint=True))
    model = workload.build_model(cfg, device="cuda")
    workload.random_init_(model, 0, 0.02)
    sched = make_schedule(timestep_respacing=[1000])
    batch = synthetic_batch(0, 0, 2, (4, *workload.latent_size(cfg)),
                            (1, 120, 4096), sched.n_steps, "cuda")
    params = tr.trainable(model)
    opt = tr.make_optimizer(lr=1e-4, grad_clip=1.0)
    state, ema = opt.init(params), tr.init_ema(params)
    step = tr.make_train_step(model, sched, opt)
    gen = torch.Generator("cuda").manual_seed(1)
    step(ema, state, batch, gen)
    torch.cuda.synchronize()
    phase[0] = "fwd"
    _counters.reset()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step(ema, state, batch, gen)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    k3 = _counters.snapshot()["attention_bnhd"]["launches"]
    order = ("start", "forward", "backward", "optimizer", "ema")
    span = {b: marks[a].elapsed_time(marks[b])
            for a, b in zip(order, order[1:])}
    by_kernel = defaultdict(float)
    for ev in prof.key_averages():
        if (ev.device_type.name == "CUDA"
                and ev.key not in (recompute, attn_bwd)
                and ev.self_device_time_total > 0):
            by_kernel[ev.key] += ev.self_device_time_total / 1e3
    device = sum(by_kernel.values())

    def is_k3(name):
        return "attn" in name.lower()
    k3_ms = sum(ms for n, ms in by_kernel.items() if is_k3(n))
    re = range_kernels(prof, recompute)
    re_ms = sum(ms for n, ms in re.items() if not is_k3(n))
    re_k3 = sum(ms for n, ms in re.items() if is_k3(n))
    bwd_ms = sum(range_kernels(prof, attn_bwd).values())
    groups = {
        "forward (without K3)": span["forward"] - (k3_ms - re_k3),
        "recompute (without K3)": re_ms,
        f"K3 (forward and recompute, {k3} launches)": k3_ms,
        attn_bwd: bwd_ms,
        "the rest of the backward": span["backward"] - re_ms - re_k3
        - bwd_ms,
        "AdamW + clipping": span["optimizer"],
        "EMA": span["ema"]}
    print(f"train STDiT-XL/2 16x512x512, batch 2, grad_checkpoint: one "
          f"step, wall {wall:.1f} ms, device {device:.1f} ms (the CUDA "
          f"events' span {sum(span.values()):.1f}), idle share "
          f"{max(0.0, 1 - device / wall):.3f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    for grp, ms in groups.items():
        print(f"    {ms:9.2f} ms  {grp}")
    print("  top kernels:")
    for k, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {ms:9.2f} ms  {k[:110]}")
    return 0


def mp_draws_main() -> int:
    """The CLI's MP samples against fp over input draws (module
    docstring)."""
    import json
    import tempfile

    import numpy as np
    import torch
    import chip_smoke as cs
    from viditq_tpu_torch import cli
    from viditq_tpu_torch.kernels import _build
    from viditq_tpu_torch.pipelines.inference import fp_sample, quant_sample
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    from viditq_tpu_torch.utils import workload
    from viditq_tpu_torch.utils.config import load_quant_config
    print(cs.nvidia_smi_line(), flush=True)
    _build.lib()
    with tempfile.TemporaryDirectory(prefix="viditq_mp_draws_") as tmpd:
        config = cs.cli_workload(Path(tmpd), cs.CLI_STEPS)
        args = cli.build_parser().parse_args(["inference", "--config",
                                              config])
        cfg = workload.load_py_config(config)
    z = cli._latent(args, cfg, 1)[0]
    y, mask = cli._load_embeds(args, cfg, 1)
    draws = {"cli": (z, y, mask), "cli, y x 0.1": (z, y * 0.1, mask),
             "cli, z x 0.5, y x 0.1": (z * 0.5, y * 0.1, mask),
             "slice": cs.slice_inputs("stdit", cfg, 0.5, 120,
                                      np.random.default_rng(0))}

    def seeded(plan=None):
        model = workload.build_model(cfg, plan and plan.resolver(),
                                     device="cuda")
        workload.random_init_(model, cli.INIT_SEED, cli.INIT_SCALE)
        return model

    def rel(a, b):
        return float((a.float().cpu() - b).norm() / b.norm())

    fp_sampler = workload.build_sampler(cfg)
    model = seeded()
    fp = {k: fp_sample(model, fp_sampler, *d).float().cpu()
          for k, d in draws.items()}
    model = None
    out = {}
    for label, path in (("viditq_w4a8", cs.VIDITQ_W4A8_PLAN),
                        ("naive", cs.NAIVE_PLAN)):
        plan = load_quant_config(str(path))
        sampler = workload.build_sampler(cfg, cfg_split=plan.cfg_split)
        for draw, d in draws.items():
            t0 = time.time()
            model = seeded(plan)
            slot_map = None
            if label == "naive":  # get-calib-data, then ptq
                slot_map = cs.calibrate_static(model, plan, fp_sampler,
                                               *d)[0]
            else:  # no checkpoint: weight tables from the parameters
                calibrate_weight_tables(model)
            run = cs.mp_sampler(cfg, "cuda", plan, sampler, cs.MP_WEIGHT,
                                cs.MP_ACT, act_slot_map=slot_map)
            mp = rel(run(model, *d), fp[draw])
            own = rel(quant_sample(model, sampler, *d, act_slot_map=slot_map),
                      fp[draw])
            model = run = None
            torch.cuda.empty_cache()
            out[f"{label} | {draw}"] = {"mp": mp, "plan_bits": own}
            print(f"mp-draws {label}, draws {draw!r}: rel err from fp with "
                  f"the t20 MP {mp:.5g}, at the plan's own bits {own:.5g} "
                  f"({time.time() - t0:.1f} s)", flush=True)
    print(json.dumps({"mp_draws": out}), flush=True)
    return 0


def profile_sampling(run, steps):
    """One whole sampling run profiled after a warm-up run: (wall ms,
    device ms by kernel) per step, the sampler's host work included."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            run()
            torch.cuda.synchronize()
            wall = (time.time() - t0) * 1e3
    by_kernel = defaultdict(float)
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0:
            by_kernel[ev.key] += ev.self_device_time_total / 1e3 / steps
    return wall / steps, by_kernel


def print_groups(label, wall, by_kernel, top=8):
    device = sum(by_kernel.values())
    groups = defaultdict(float)
    for k, ms in by_kernel.items():
        groups[group_of(k)] += ms
    print(f"{label}, wall {wall:.1f} ms, device {device:.1f} ms, idle "
          f"share {max(0.0, 1 - device / wall):.3f}", flush=True)
    for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.2f} ms  {grp}")
    print("  top kernels:")
    for k, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ms:9.2f} ms  {k[:110]}")


def pixart_alpha_main() -> int:
    """PixArt-α 512 through its samplers (module docstring)."""
    import torch
    import chip_smoke as cs
    from viditq_tpu_torch import cli
    from viditq_tpu_torch.kernels import _build
    from viditq_tpu_torch.pipelines.inference import (fp_sample,
                                                      get_calib_data,
                                                      quant_sample)
    from viditq_tpu_torch.pipelines.ptq import run_ptq
    from viditq_tpu_torch.quant.native_pack import pack_native_weights
    from viditq_tpu_torch.samplers import SASolverSampler
    from viditq_tpu_torch.utils import workload
    from viditq_tpu_torch.utils.config import load_quant_config
    print(cs.nvidia_smi_line(), flush=True)
    _build.lib()
    config = str(cs.PIXART_WORKLOAD)
    cfg = workload.load_py_config(config)
    args = cli.build_parser().parse_args(["inference", "--config", config])
    y, mask = cli._load_embeds(args, cfg, 1)
    shape = (1, 4, *workload.latent_size(cfg))
    z = cli.noise(shape, args.seed, "cuda")
    plan = load_quant_config(str(cs.PIXART_PLAN)).with_backend("native")

    def seeded(resolver=None):
        model = workload.build_model(cfg, resolver, device="cuda")
        return workload.random_init_(model, cli.INIT_SEED, cli.INIT_SCALE)
    fp_model, q_model = seeded(), seeded(plan.resolver())
    multistep = workload.build_sampler(cfg)
    run_ptq(q_model, get_calib_data(fp_model, multistep, z, y, mask), plan)
    pack_native_weights(q_model)
    steps = multistep.steps
    samplers = {"multistep (dpms)": multistep,
                "sa-solver": workload.build_sampler(
                    cfg, override_type="sa-solver"),
                "sa-solver eta 1 (stochastic)": SASolverSampler(
                    steps, cfg_scale=multistep.cfg_scale, eta=1.0)}
    for arm, model, sample in (("bf16", fp_model, fp_sample),
                               ("w8a8", q_model, quant_sample)):
        for name, sampler in samplers.items():
            def run(_m=model, _s=sampler, _f=sample):
                return _f(_m, _s, z, y, mask,
                          generator=cli.sampler_generator(shape, args.seed,
                                                          "cuda"))
            wall, by_kernel = profile_sampling(run, steps)
            print_groups(f"pixart_alpha {arm} {name}: one step of a "
                         f"{steps}-step run", wall, by_kernel)
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
    if "--train" in args:
        return train_main()
    if "--mp-draws" in args:
        return mp_draws_main()
    if "--slices" in args and args[args.index("--slices") + 1] == \
            "pixart_alpha":
        return pixart_alpha_main()
    import chip_smoke as cs
    from viditq_tpu_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    _build.lib()
    slices = (("stdit", cs.STDIT_CFG, 120), ("sigma", cs.SIGMA_CFG, 300),
              ("latte", cs.LATTE_CFG, 1), ("dit", cs.DIT_CFG, None),
              ("dit_l", cs.DIT_L_CFG, None), ("mmdit", cs.MMDIT_CFG, 77),
              ("stdit_h6", cs.STDIT_H6_CFG, 120),
              ("dit_l_h4", cs.DIT_L_H4_CFG, None))
    plan_slices = (("stdit_plans", cs.plan_cfg(cs.STDIT_CFG), 120),
                   ("alpha", cs.plan_cfg(cs.ALPHA_CFG), 120),
                   ("sigma_plans", cs.plan_cfg(cs.SIGMA_CFG), 300))
    if "--slices" in args:
        keep = args[args.index("--slices") + 1].split(",")
        slices = tuple(s for s in slices + plan_slices if s[0] in keep)
    arms_kept = (args[args.index("--arms") + 1].split(",")
                 if "--arms" in args else None)
    for name, cfg, n_prompt in slices:
        t = torch.tensor([500.0, 500.0], device="cuda")
        # the slice's own draws (`chip_smoke.slice_inputs`), one latent in
        # both CFG rows
        z, y, mask = cs.slice_inputs(name, cfg, 1.0, n_prompt,
                                     np.random.default_rng(0))
        x = torch.cat([z, z])
        model, model_plan = None, None
        tables = {}
        for arm in cs.SLICE_KERNELS[name]:
            if arms_kept is not None and arm not in arms_kept:
                continue
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
            print_groups(f"{name} {arm}: one CFG step ({len(calls)} forward"
                         f"{'s' if len(calls) > 1 else ''})", wall,
                         by_kernel)
        model = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
