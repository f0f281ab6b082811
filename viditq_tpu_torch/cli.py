"""Command-line entry points of the PyTorch port (port of
`viditq_tpu/cli.py`): `python -m viditq_tpu_torch.cli <command> ...`, or
the `viditq-torch` script.

Command map to the reference scripts:
  split-ckpt        <- t2v/scripts/split_ckpt.py (+ conversion to the
                       port's state dict)
  inference         <- t2v/scripts/inference.py, t2i/scripts/inference.py
  get-calib-data    <- t2v/scripts/get_calib_data.py, t2i analog
  ptq               <- t2v/scripts/ptq.py, t2i/scripts/ptq.py
  quant-generate    <- t2v/scripts/quant_txt2video.py, t2i quant_txt2img.py
  quant-generate-mp <- t2v/scripts/quant_txt2video_mp.py
  get-sensitivity   <- t2v/scripts/get_sensitivity.py
  sweep-alpha       <- t2v/scripts/sweep_alpha.py
  smooth-quant-list <- t2v/scripts/get_smooth_quant_list.py
  calibrate-ptqd-k  <- t2v/scripts/calibrate_ptqd_k.py (k_t from matched
                       trajectories)
  train             <- t2v/scripts/train.py (synthetic batches, or a CSV
                       dataset encoded by the VAE inside the loop)
  extract-features  <- t2i/tools/extract_features.py (VAE latents of a
                       CSV dataset)

The commands take the JAX CLI's flags and write its files and keys:
`fp_samples.npz` and `quant_samples.npz` (`samples`), `calib_data.npz`
(`xs`, `ts`, `y`, `mask`; an empty `mask` for none), `quant_ckpt.npz`
(`utils/ckpt.save_quant_ckpt`, the JAX package's format),
`quant_config_snapshot.yaml`, `sensitivity.json`, `best_alpha.json`,
`smooth_quant_list.txt`. Calibration data, quant checkpoints and text
embeds cross between the packages; the parameters do not (`split-ckpt`
writes the port's `.pt`, the JAX one a flax msgpack; both come from the
same reference `.pth`). Every model runs on the card unless `--device
cpu` is given; without CUDA the model build raises. Without
`--ckpt_path` the parameters are drawn from seed 0 (normal x 0.02,
`utils/workload.random_init_`), not the JAX package's flax init, so such
runs do not match the JAX CLI's.

`--sampler_type` picks the loop (JAX cli.py:60-62, the reference's
`quant_txt2img.py:138-182`): 'ddim' and 'iddpm' (the ancestral loop) keep
the config's scheduler, 'dpms'/'dpm-solver', 'sa-solver', 'lcm' and 'edm'
replace a scheduler of another type (`utils/workload.build_sampler`);
`inference`, `get-calib-data`, `quant-generate` and `get-sensitivity`
sample by it (mixed precision and the block-group sensitivity stay on
DDIM, as in JAX). The stochastic samplers draw from `sampler_generator`:
--seed on --device, after the latent.

`ptq` on a plan that asks for reconstruction (`quant.weight.optimization`
with AdaRound rounding, `configs/opensora/w4a8_adaround.yaml`) runs it after
the calibration, as the JAX CLI does (cli.py:240-268): block granularity
(`quant/reconstruction.model_block_reconstruction`, asym) or layer
granularity (`capture_layer_io`, `model_reconstruction`) on the first
calibration step's rows (x, t, y, mask); the learned `w_alpha` tables go
into `quant_ckpt.npz`.

`train` (JAX cli.py:569-626) trains the workload's model on synthetic
batches (`pipelines/train.train_loop`: latents (4, *latent_size),
captions (1, model_max_length, caption_channels), batch 2 x --grad_accum)
from JAX's initialisers (`utils/workload.jax_init_`, seed 0: the JAX
command starts from `model.init`), with `--resume_from` a
`train_state_<step>.pt` of `--ckpt_every` (the port's one format: the
JAX `--ckpt_format` choices are flax msgpack and orbax, not ported). A
config's `model=dict(grad_checkpoint=True)` recomputes each block in the
backward pass. `--dp/--sp/--tp` above 1 run under torchrun (`python -m
torch.distributed.run --nproc_per_node <dp*sp*tp> -m viditq_tpu_torch.cli
train ...`; a world size that differs from dp*sp*tp refuses): the mesh of
`parallel/mesh.py` over nccl on the card or gloo with `--device cpu`, the
batch over dp with ZeRO-sharded moments, the blocks' linears over tp;
the model carries no sp mesh, as in JAX (cli.py:580), so sp ranks
compute the same replica. `--data_path` (JAX cli.py:593-617) trains over
a CSV dataset of `path,text` rows (`data/datasets.DatasetFromCSV` at the
config's num_frames and image_size; `pipelines/train.train_entry`, epochs
of `--batch_size` items from the resumable sampler), each batch's pixels
encoded to the VAE's posterior mean inside the loop (the config's `vae`,
encoder only, `utils/workload.build_vae`), with null captions of the
model's shape; `--no_vae` takes each item's 'video' as the latent as it
is; `--vae_ckpt` is the port's params file of the VAE (`utils/ckpt.
save_params`; a file of the whole autoencoder serves the encoder), else
the VAE is drawn from JAX's initialisers (`utils/workload.jax_init_`, seed
0) with the JAX CLI's warning.

`extract-features` (JAX cli.py:533-567) encodes a CSV dataset's clips
(`--num_frames` > 0: `VideoAutoencoderKL`) or images (`AutoencoderKL`) at
`--image_size` to their posterior means and writes `features.npz`
(`latents`, `texts`), the VAE as `train`'s.

Not ported: get-text-embeds and the 'clip' metric (T5/CLIP weights), and
export (StableHLO).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

from viditq_tpu_torch.utils import workload

DEFAULT_DEVICE = "cuda"
INIT_SEED, INIT_SCALE = 0, 0.02


def _common(parser):
    parser.add_argument("--config", required=True,
                        help="python workload config (16x512x512.py style)")
    parser.add_argument("--ckpt_path", default=None,
                        help="the port's params file (.pt, from split-ckpt); "
                             "without it the parameters are drawn from seed "
                             "0, normal x 0.02 (not the JAX package's flax "
                             "init)")
    parser.add_argument("--text_embeds_path", default=None,
                        help="precomputed text embeds npz")
    parser.add_argument("--save_dir", default="outputs")
    parser.add_argument("--batch_ids", default=None,
                        help="comma-separated prompt indices")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--sampler_type", default="ddim",
                        choices=workload.SAMPLER_TYPES)
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="torch device of the model (the card; 'cpu' "
                             "runs the kernels' plain versions)")


def _quant_args(parser):
    parser.add_argument("--ptq_config", required=True,
                        help="quant plan YAML (reference schema)")
    parser.add_argument("--quant_ckpt", default=None,
                        help="quant-params npz (from ptq, of either package)")
    parser.add_argument("--part_fp", action="store_true", default=True,
                        help="always on, as in the JAX CLI: the plan's "
                             "part_fp_list layers stay fp")
    parser.add_argument("--timestep_wise", action="store_true")
    parser.add_argument("--smooth_quant_alpha", type=float, default=None)
    parser.add_argument("--backend", default="simulate",
                        choices=["simulate", "native"])


def noise(shape, seed: int, device: str):
    """The initial latent: float32 normal draws of a generator seeded with
    seed on the device."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device,
                       dtype=torch.float32)


def sampler_generator(shape, seed: int, device: str):
    """The stochastic samplers' generator (the ancestral loop, SA-Solver
    with tau > 0, LCM): seeded with seed on the device and advanced past
    the latent's draw (`noise` of shape), so one seed gives the latent and
    then the sampler's draws as one stream."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return g


def _plan(args):
    from viditq_tpu_torch.utils.config import load_quant_config
    plan = load_quant_config(
        args.ptq_config, timestep_wise=getattr(args, "timestep_wise", False),
        smooth_quant_alpha=getattr(args, "smooth_quant_alpha", None))
    if getattr(args, "backend", "simulate") == "native":
        plan = plan.with_backend("native")
    return plan


def init_params(model, args):
    """The model's parameters from `--ckpt_path`, else the seeded draw."""
    from viditq_tpu_torch.utils import ckpt as ckpt_utils
    if args.ckpt_path:
        return ckpt_utils.load_params_into(model, args.ckpt_path)
    return workload.random_init_(model, INIT_SEED, INIT_SCALE)


def _setup(args, quant: bool = False):
    """(cfg, plan, resolver, model, sampler): the model on args.device with
    its parameters (`init_params`) and uncalibrated tables."""
    cfg = workload.load_py_config(args.config)
    plan = resolver = None
    if quant:
        plan = _plan(args)
        resolver = plan.resolver()
    model = workload.build_model(cfg, resolver, device=args.device)
    init_params(model, args)
    sampler = workload.build_sampler(
        cfg, cfg_split=bool(plan.cfg_split) if plan else False,
        override_type=getattr(args, "sampler_type", None))
    return cfg, plan, resolver, model, sampler


def _load_embeds(args, cfg, n_default=2):
    """(y [2n, 1, L, C] as [cond; null], mask [n, L]) on args.device: the
    embeds file's prompts, or the JAX CLI's smoke-mode draws (numpy seed
    0, an all-ones mask)."""
    import torch
    from viditq_tpu_torch.models.text_encoder import PrecomputedTextEmbeds
    if args.text_embeds_path and os.path.exists(args.text_embeds_path):
        emb = PrecomputedTextEmbeds(args.text_embeds_path)
        ids = ([int(i) for i in args.batch_ids.split(",")]
               if args.batch_ids else list(range(min(n_default,
                                                     len(emb.y)))))
        sel = emb.select(ids)
        return (sel["y"].float().to(args.device),
                sel["mask"].to(args.device))
    rng = np.random.default_rng(0)
    print("[viditq] no text embeds provided; using random embeds",
          file=sys.stderr)
    mcfg = cfg.get("model", {})
    cap = mcfg.get("caption_channels", 4096)
    L = mcfg.get("model_max_length", 120)
    y = torch.from_numpy(rng.standard_normal(
        (2 * n_default, 1, L, cap)).astype(np.float32)).to(args.device)
    mask = torch.ones((n_default, L), dtype=torch.int32, device=args.device)
    return y, mask


def _latent(args, cfg, n):
    """(z, the samplers' generator) of n samples from --seed."""
    shape = (n, 4, *workload.latent_size(cfg))
    return (noise(shape, args.seed, args.device),
            sampler_generator(shape, args.seed, args.device))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _save_samples(args, name: str, samples, seconds: float, steps: int):
    out = os.path.join(args.save_dir, name)
    os.makedirs(args.save_dir, exist_ok=True)
    arr = _np(samples)
    np.savez(out, samples=arr)
    print(f"saved {arr.shape} -> {out} ({steps} steps in {seconds:.3f} s)")
    return {"out": out, "sample_seconds": seconds, "steps": steps}


def _steps(sampler) -> int:
    return getattr(sampler, "steps", None) or sampler.schedule.n_steps


def _timed(fn, device):
    """fn() and its seconds, the device synchronised on both ends."""
    import torch
    sync = (torch.cuda.synchronize if str(device).startswith("cuda")
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def cmd_split_ckpt(args):
    """reference .pth -> the port's params file, fused qkv split."""
    from viditq_tpu_torch.utils import ckpt as ckpt_utils
    ckpt_utils.save_params(args.dst,
                           ckpt_utils.convert_dit_checkpoint(args.src))
    print(f"converted {args.src} -> {args.dst}")
    return {"out": args.dst}


def cmd_inference(args):
    from viditq_tpu_torch.pipelines import inference as inf
    cfg, _, _, model, sampler = _setup(args)
    n = args.num_samples
    y, mask = _load_embeds(args, cfg, n)
    z, gen = _latent(args, cfg, n)
    samples, secs = _timed(lambda: inf.fp_sample(
        model, sampler, z, y, mask, sampler_type=args.sampler_type,
        generator=gen), args.device)
    return _save_samples(args, "fp_samples.npz", samples, secs,
                         _steps(sampler))


def cmd_get_calib_data(args):
    from viditq_tpu_torch.pipelines import inference as inf
    cfg, _, _, model, sampler = _setup(args)
    n = args.num_samples
    y, mask = _load_embeds(args, cfg, n)
    z, gen = _latent(args, cfg, n)
    calib = inf.get_calib_data(model, sampler, z, y, mask,
                               sampler_type=args.sampler_type,
                               generator=gen)
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, "calib_data.npz")
    np.savez(out, xs=_np(calib["xs"]), ts=_np(calib["ts"]),
             y=_np(calib["y"]),
             mask=(calib["mask"].cpu().numpy() if calib["mask"] is not None
                   else np.ones(0)))
    print(f"saved calib trajectories {tuple(calib['xs'].shape)} -> {out}")
    return {"out": out}


def load_calib_data(path: str, device: str):
    """A calib_data.npz of either package as tensors on the device."""
    import torch
    data = np.load(path)
    calib = {k: torch.from_numpy(np.array(data[k])).to(device)
             for k in ("xs", "ts", "y")}
    calib["mask"] = (torch.from_numpy(np.array(data["mask"])).to(device)
                     if data["mask"].size else None)
    return calib


def cmd_ptq(args):
    import yaml
    from viditq_tpu_torch.pipelines.ptq import run_ptq
    from viditq_tpu_torch.quant import reconstruction as recon
    from viditq_tpu_torch.utils import ckpt as ckpt_utils
    from viditq_tpu_torch.utils.logging import log_invocation, setup_logger
    logger = setup_logger(args.save_dir, "ptq_run")
    log_invocation(logger, args)
    cfg, plan, _, model, _ = _setup(args, quant=True)
    # the quant plan beside the outputs (reference ptq.py:41-47, with
    # --smooth_quant_alpha written into the copy, ptq.py:135-148)
    os.makedirs(args.save_dir, exist_ok=True)
    with open(args.ptq_config) as f:
        plan_yaml = yaml.safe_load(f)
    if args.smooth_quant_alpha is not None:
        sq = (plan_yaml.get("quant", {}).get("activation", {})
              .get("quantizer", {}).get("smooth_quant"))
        if sq and sq.get("enable"):  # the live run gates on enable too
            sq["alpha"] = args.smooth_quant_alpha
    with open(os.path.join(args.save_dir, "quant_config_snapshot.yaml"),
              "w") as f:
        yaml.safe_dump(plan_yaml, f, sort_keys=False)
    calib = load_calib_data(args.calib_data, args.device)
    res, secs = _timed(lambda: run_ptq(
        model, calib, plan,
        resume_w_quantized_path=args.resume_with_w_quantized), args.device)
    done = {"seconds": secs}
    if recon.wants_reconstruction(plan):
        # the reference's optimisation pass after the calibration (JAX
        # cli.py:240-268), on the first calibration step's rows
        rcfg = recon.recon_config(plan)
        recon_args = (calib["xs"][0], calib["ts"][0].float(), calib["y"],
                      calib["mask"])
        wopt = plan.weight_opt
        logger.info("reconstruction: granularity=%s iters=%d",
                    wopt.granularity, wopt.iters)
        timings = {}

        def run():
            if wopt.granularity == "block":
                return recon.model_block_reconstruction(
                    model, recon_args, rcfg, mask=calib["mask"],
                    timings=timings)
            io = recon.capture_layer_io(model, recon_args)
            return recon.model_reconstruction(model, io, rcfg)
        _, done["recon_seconds"] = _timed(run, args.device)
        done["recon_timings"] = timings
        logger.info("reconstructed in %.3f s", done["recon_seconds"])
    out = os.path.join(args.save_dir, "quant_ckpt.npz")
    meta = {"act_slot_map": res.act_slot_map, "calib_ts": res.calib_ts,
            "ptq_config": args.ptq_config}
    ckpt_utils.save_quant_ckpt(out, model, meta)
    logger.info("calibrated in %.3f s", secs)
    print(f"saved quant params -> {out}")
    return {"out": out, **done}


def prepare_quant_model(model, plan, quant_ckpt=None):
    """The model's quant tables from a quant checkpoint (either
    package's), else min-max weight tables from its parameters; then the
    packed slabs of a native plan. Returns the act slot map (None without
    static acts)."""
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    from viditq_tpu_torch.quant.native_pack import pack_native_weights
    from viditq_tpu_torch.utils import ckpt as ckpt_utils
    act_slot_map = None
    if quant_ckpt:
        meta = ckpt_utils.load_quant_ckpt(quant_ckpt, model)
        if meta:
            act_slot_map = meta.get("act_slot_map")
    else:
        print("[viditq] no quant ckpt; calibrating weights from params",
              file=sys.stderr)
        calibrate_weight_tables(model)
    if plan.uses_native():
        pack_native_weights(model)
    return act_slot_map


def cmd_quant_generate(args, mp: bool = False):
    from viditq_tpu_torch.pipelines import inference as inf
    from viditq_tpu_torch.utils.logging import log_invocation, setup_logger
    logger = setup_logger(args.save_dir, "quant_inference_run")
    log_invocation(logger, args)
    cfg, plan, _, model, sampler = _setup(args, quant=True)
    n = args.num_samples
    y, mask = _load_embeds(args, cfg, n)
    z, gen = _latent(args, cfg, n)
    act_slot_map = prepare_quant_model(model, plan, args.quant_ckpt)
    if mp:
        from viditq_tpu_torch.pipelines.mixed_precision import (
            build_mp_sampler)
        from viditq_tpu_torch.utils.config import load_bitwidth_config
        mp_w = load_bitwidth_config(args.time_mp_config_weight)
        mp_a = (load_bitwidth_config(args.time_mp_config_act)
                if args.time_mp_config_act else None)
        run = build_mp_sampler(
            lambda r: workload.build_model(cfg, r, device=args.device),
            sampler, plan, mp_w, mp_a, act_slot_map=act_slot_map)
        samples, secs = _timed(lambda: run(model, z, y, mask), args.device)
    else:
        samples, secs = _timed(lambda: inf.quant_sample(
            model, sampler, z, y, mask, act_slot_map=act_slot_map,
            sampler_type=args.sampler_type, generator=gen), args.device)
    logger.info("sampled in %.3f s", secs)
    return _save_samples(args, "quant_samples.npz", samples, secs,
                         _steps(sampler))


def _metric_fns(args):
    from viditq_tpu_torch.utils.metrics import make_sensitivity_metric
    prompts = None
    if args.prompts:
        if os.path.exists(args.prompts):
            with open(args.prompts) as f:
                prompts = [ln.strip() for ln in f if ln.strip()]
        else:
            prompts = args.prompts.split(",")
    names = args.metric.split(",")
    return names, {m: make_sensitivity_metric(
        m, prompts=prompts, clip_model_path=args.clip_model) for m in names}


def cmd_get_sensitivity(args):
    """One generation per target (or per bit x block x group x window in
    the block-group mode) with only it quantized, scored against the fp
    generation; every model built takes the first one's parameters."""
    import torch
    from viditq_tpu_torch.pipelines import analysis
    from viditq_tpu_torch.pipelines.inference import quant_sample
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    from viditq_tpu_torch.quant.native_pack import pack_native_weights
    from viditq_tpu_torch.samplers.iddpm import default_qctx_factory
    from viditq_tpu_torch.utils import ckpt as ckpt_utils
    metric_names, metric_fns = _metric_fns(args)
    metric_fn = metric_fns[metric_names[0]]
    cfg, plan, _, model, sampler = _setup(args, quant=True)
    y, mask = _load_embeds(args, cfg, 1)
    z = _latent(args, cfg, 1)[0]
    base = plan.default_layer
    params = {k: v.detach() for k, v in model.named_parameters()}
    del model
    qctx_factory = default_qctx_factory("quant")

    def build(resolver):
        m = workload.build_model(cfg, resolver, device=args.device)
        ckpt_utils.load_params_into(m, params)
        calibrate_weight_tables(m)
        # the JAX command packs no slabs (a native plan then runs on
        # zero slabs there); the port packs them
        pack_native_weights(m)
        return m

    def run_with_resolver(resolver):
        # every target's run from the same draws (JAX cli.py:432)
        return quant_sample(build(resolver), sampler, z, y, mask,
                            sampler_type=args.sampler_type,
                            generator=sampler_generator(
                                z.shape, args.seed, args.device))

    groups = (args.targets.split(",") if args.targets
              else list(analysis.QUANT_GROUPS))
    with torch.no_grad():
        if args.block_group_wise_quant:
            fp_model = build(None)

            def fp_apply(x, t, yy, mm, qctx=None):
                return fp_model(x, t, yy, mm)

            def make_q_apply(resolver):
                m = build(resolver)

                def q_apply(x, t, yy, mm, qctx):
                    return m(x, t, yy, mm, qctx=qctx)
                return q_apply

            bits = ([int(b) for b in args.block_group_bits.split(",")]
                    if args.block_group_bits else [4, 6, 8])
            scores = analysis.block_group_sensitivity(
                sampler, fp_apply, make_q_apply, z, y, mask, base,
                n_blocks=len(fp_model.blocks), qctx_factory=qctx_factory,
                groups=groups, bits=bits,
                split_timestep=args.split_timestep,
                fp_patterns=plan.fp_patterns, metric_fn=metric_fn)
        elif len(metric_fns) > 1:
            vectors = analysis.sensitivity_scan_multi(
                run_with_resolver, base, groups, metric_fns,
                fp_patterns=plan.fp_patterns)
            scores = {"combined": analysis.combine_sensitivity(vectors),
                      "per_metric": vectors}
        else:
            scores = analysis.sensitivity_scan(
                run_with_resolver, base, groups,
                fp_patterns=plan.fp_patterns, metric_fn=metric_fn)
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, "sensitivity.json")
    with open(out, "w") as f:
        json.dump(scores, f, indent=2)
    print(json.dumps(scores, indent=2))
    return {"out": out, "scores": scores}


def _probe(args):
    """The analysis commands' one fp forward: (model, resolver, (z, t =
    500, y cond, mask))."""
    import torch
    cfg, _, resolver, model, _ = _setup(args, quant=True)
    y, mask = _load_embeds(args, cfg, 1)
    z = _latent(args, cfg, 1)[0]
    t0 = torch.full((1,), 500.0, device=args.device)
    return model, resolver, (z, t0, y[:1], mask)


def cmd_sweep_alpha(args):
    from viditq_tpu_torch.pipelines import analysis
    model, resolver, example = _probe(args)
    best = analysis.sweep_alpha(model, example, resolver)
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, "best_alpha.json")
    with open(out, "w") as f:
        json.dump(best, f, indent=2)
    print(f"saved per-layer alpha -> {out}")
    return {"out": out, "best": best}


def cmd_smooth_quant_list(args):
    from viditq_tpu_torch.pipelines import analysis
    model, resolver, example = _probe(args)
    picks = analysis.smooth_quant_candidates(
        model, example, resolver, act_ratio_threshold=args.threshold)
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, "smooth_quant_list.txt")
    with open(out, "w") as f:
        f.write("\n".join(picks) + "\n")
    print(f"{len(picks)} CB candidates -> {out}")
    return {"out": out, "picks": picks}


def cmd_calibrate_ptqd_k(args):
    """k_t per step from matched fp and quantized trajectories (`outs`
    [n_steps, ...] in each npz) -> ptqd_k.npy (JAX cli.py:629-635)."""
    from viditq_tpu_torch.pipelines.analysis import calibrate_ptqd_k
    k = calibrate_ptqd_k(np.load(args.fp_trajectory)["outs"],
                         np.load(args.quant_trajectory)["outs"])
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, "ptqd_k.npy")
    np.save(out, k)
    print(f"k_t per step: {k}")
    return {"out": out, "k": k}


RANDOM_VAE_NOTE = {
    "extract-features": "[viditq] no VAE ckpt; using random-init VAE "
                        "(structural run)",
    "train": "[viditq] training with a RANDOM-weight VAE (pass --vae_ckpt "
             "for real latents)"}


def init_vae(vae, vae_ckpt, cmd: str):
    """The VAE's parameters from `vae_ckpt` (the port's params file; it may
    hold more, e.g. the decoder of an encoder-only build), else JAX's
    initialisers from seed 0 with the JAX CLI's warning."""
    from viditq_tpu_torch.utils import ckpt as ckpt_utils
    if vae_ckpt:
        return ckpt_utils.load_params_into(vae, vae_ckpt, extra_ok=True)
    print(RANDOM_VAE_NOTE[cmd], file=sys.stderr)
    return workload.jax_init_(vae, INIT_SEED)


def cmd_extract_features(args):
    """VAE latents of a dataset CSV -> features.npz (JAX cli.py:533-567;
    reference t2i/tools/extract_features.py). Returns the file ('out'),
    the encode loop's 'seconds' and the number of latents ('n')."""
    import torch
    from viditq_tpu_torch.data.datasets import (DatasetFromCSV,
                                                StatefulSampler,
                                                batch_iterator)
    video = args.num_frames > 0
    ds = DatasetFromCSV(args.csv, num_frames=args.num_frames or None,
                        image_size=(args.image_size, args.image_size),
                        root=args.data_root)
    vae = workload.build_vae(
        {"vae": {"type": "VideoAutoencoderKL" if video else "AutoencoderKL"}},
        device=args.device, decoder=False)
    init_vae(vae, args.vae_ckpt, "extract-features")

    def run():
        latents, texts = [], []
        sampler = StatefulSampler(len(ds), shuffle=False)
        with torch.no_grad():
            for batch in batch_iterator(ds, sampler, args.batch_size):
                x = torch.from_numpy(batch["video"]).to(args.device)
                latents.append(_np(vae.encode(x)))
                texts.extend(batch["text"])
        return latents, texts
    (latents, texts), seconds = _timed(run, args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, "features.npz")
    np.savez(out, latents=np.concatenate(latents),
             texts=np.asarray(texts, dtype=object) if texts else
             np.zeros(0))
    n = sum(lat.shape[0] for lat in latents)
    print(f"saved {n} latents -> {out} ({seconds:.3f} s)")
    return {"out": out, "seconds": seconds, "n": n}


def cmd_train(args):
    """Synthetic-data training, or a CSV dataset's with --data_path (module
    docstring), over a mesh under torchrun when --dp * --sp * --tp > 1.
    Returns the last
    checkpoint written ('out', None without --ckpt_every), 'seconds' of
    the loop, 'ckpt_seconds' of its checkpoint writes, 'ms_per_step'
    after the first step without those writes (the device synchronised
    after the first step and at the end), 'losses' (every step's run), and
    the final 'params' and 'ema' (all None where a resumed --data_path run
    finds its epochs done)."""
    import torch
    from viditq_tpu_torch.pipelines.train import (make_encode_batch,
                                                  train_entry, train_loop)
    world = args.dp * args.sp * args.tp
    launched = int(os.environ.get("WORLD_SIZE", "1"))
    if launched != world:
        raise SystemExit(
            f"train: the world size {launched} differs from --dp x --sp x "
            f"--tp = {world}: run it under torchrun (python -m "
            f"torch.distributed.run --nproc_per_node {world} ...)")
    if not args.data_path and (args.no_vae or args.vae_ckpt):
        raise ValueError("--no_vae and --vae_ckpt apply to --data_path "
                         "training only")
    mesh, device = None, args.device
    if world > 1:
        from viditq_tpu_torch.parallel.mesh import (init_distributed,
                                                    make_mesh)
        init_distributed(device=device)
        if torch.device(device).type == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
        # the model carries no sp mesh, as in JAX (cli.py:580): the sp
        # ranks compute the same replica (ROADMAP C21)
        mesh = make_mesh(dp=args.dp, sp=args.sp, tp=args.tp)
    cfg = workload.load_py_config(args.config)
    model = workload.build_model(cfg, device=device)
    if not args.resume_from:  # else the checkpoint's parameters
        workload.jax_init_(model, INIT_SEED)
    mcfg = cfg.get("model", {})
    cap_shape = (1, mcfg.get("model_max_length", 120),
                 mcfg.get("caption_channels", 4096))
    sync = (torch.cuda.synchronize if str(device).startswith("cuda")
            else (lambda: None))
    marks = []

    def mark(i):  # i: the global step index
        if not marks:  # after the first step only: no per-step sync
            sync()
            marks.append((i, time.perf_counter()))

    kw = dict(latent_shape=(4, *workload.latent_size(cfg)),
              caption_shape=cap_shape, lr=args.lr,
              ckpt_every=args.ckpt_every, save_dir=args.save_dir,
              grad_accum=args.grad_accum, grad_clip=args.grad_clip,
              warmup_steps=args.warmup_steps, on_step_end=mark, mesh=mesh)
    if args.data_path:
        from viditq_tpu_torch.data.datasets import DatasetFromCSV
        dataset = DatasetFromCSV(args.data_path,
                                 num_frames=cfg.get("num_frames"),
                                 image_size=tuple(cfg.get("image_size",
                                                          (256, 256))))
        vae = None
        if not args.no_vae:
            vae = workload.build_vae(cfg, device=device, decoder=False)
            init_vae(vae, args.vae_ckpt, "train")
        encode = make_encode_batch(vae, null_caption_shape=cap_shape)

        def run():
            return train_entry(model, dataset, epochs=args.epochs,
                               batch_size=args.batch_size,
                               encode_batch=encode,
                               resume_from=args.resume_from, **kw)
    else:
        def run():
            return train_loop(model, None, num_steps=args.num_steps,
                              resume_from=args.resume_from, **kw)
    sync()
    t0 = time.perf_counter()
    out = run()
    sync()
    t1 = time.perf_counter()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if out is None:
        print("nothing to train: the resume checkpoint already covers "
              "the requested epochs")
        return {"out": None, "seconds": t1 - t0, "ckpt_seconds": 0.0,
                "ms_per_step": None, "losses": [], "params": None,
                "ema": None}
    steps = len(out["step_losses"])
    losses = out["step_losses"].float().cpu().tolist()
    saves = out["ckpt_seconds"]
    later = sum(v for i, v in saves.items() if i > marks[0][0])
    print(f"trained {steps} steps in {t1 - t0:.3f} s "
          f"({sum(saves.values()):.3f} s of checkpoint writes); final loss "
          f"{losses[-1] if losses else float('nan'):.4f}")
    return {"out": out["ckpt"], "seconds": t1 - t0,
            "ckpt_seconds": sum(saves.values()),
            "ms_per_step": (1e3 * (t1 - marks[0][1] - later) / (steps - 1)
                            if steps > 1 else None),
            "losses": losses, "params": out["params"], "ema": out["ema"]}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="viditq_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("split-ckpt")
    s.add_argument("--src", required=True)
    s.add_argument("--dst", required=True)
    s.add_argument("--model_type", default="opensora",
                   choices=["opensora", "pixart"],
                   help="ignored: one conversion serves both (kept for "
                        "the JAX CLI's flags)")
    s.set_defaults(fn=cmd_split_ckpt)

    for name, fn, quant, extra in [
        ("inference", cmd_inference, False, ()),
        ("get-calib-data", cmd_get_calib_data, False, ()),
        ("quant-generate", cmd_quant_generate, True, ()),
        ("quant-generate-mp",
         functools.partial(cmd_quant_generate, mp=True), True,
         ("--time_mp_config_weight", "--time_mp_config_act")),
        ("get-sensitivity", cmd_get_sensitivity, True,
         ("--targets", "--block_group_bits")),
        ("sweep-alpha", cmd_sweep_alpha, True, ()),
        ("smooth-quant-list", cmd_smooth_quant_list, True, ()),
    ]:
        s = sub.add_parser(name)
        _common(s)
        s.add_argument("--num_samples", type=int, default=2)
        if quant:
            _quant_args(s)
        for e in extra:
            s.add_argument(e, default=None)
        if name == "get-sensitivity":
            s.add_argument("--block_group_wise_quant", action="store_true",
                           help="block x group x timestep-window mode "
                                "(reference get_sensitivity.py "
                                "block_group_wise_quant)")
            s.add_argument("--split_timestep", type=int, default=4)
            s.add_argument("--metric", default="mse",
                           help="sensitivity score(s): mse / clip_temp / "
                                "flow, comma-separated for the "
                                "multi-vector loop (per-metric vectors and "
                                "their rank-combined ranking); 'clip' is "
                                "not ported")
            s.add_argument("--clip_model", default=None,
                           help="CLIP weights for --metric clip (not "
                                "ported)")
            s.add_argument("--prompts", default=None,
                           help="comma-separated prompts for --metric clip "
                                "(or a prompt .txt, one per line)")
        if name == "smooth-quant-list":
            s.add_argument("--threshold", type=float, default=10.0)
        s.set_defaults(fn=fn)

    s = sub.add_parser("ptq")
    _common(s)
    _quant_args(s)
    s.add_argument("--calib_data", required=True)
    s.add_argument("--resume_with_w_quantized", default=None,
                   help="prior quant-ckpt npz whose weight tables are "
                        "reused (skips weight calibration; the YAML "
                        "resume_with_w_quantized.path key works too)")
    s.set_defaults(fn=cmd_ptq)

    s = sub.add_parser("train")
    s.add_argument("--config", required=True)
    s.add_argument("--num_steps", type=int, default=100)
    s.add_argument("--lr", type=float, default=1e-4)
    s.add_argument("--ckpt_every", type=int, default=0)
    s.add_argument("--save_dir", default="outputs/train")
    s.add_argument("--dp", type=int, default=1)
    s.add_argument("--sp", type=int, default=1)
    s.add_argument("--tp", type=int, default=1)
    s.add_argument("--data_path", default=None,
                   help="CSV dataset (path,text rows; the VAE encodes each "
                        "batch); omit for synthetic batches")
    s.add_argument("--epochs", type=int, default=1)
    s.add_argument("--batch_size", type=int, default=2)
    s.add_argument("--grad_accum", type=int, default=1)
    s.add_argument("--grad_clip", type=float, default=0.0)
    s.add_argument("--warmup_steps", type=int, default=0)
    s.add_argument("--resume_from", default=None,
                   help="train_state_*.pt checkpoint to resume")
    s.add_argument("--no_vae", action="store_true",
                   help="with --data_path only: the items' 'video' are "
                        "the latents")
    s.add_argument("--vae_ckpt", default=None,
                   help="with --data_path only: the VAE's params file "
                        "(.pt); else JAX's initialisers from seed 0")
    s.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the model (the card; 'cpu' runs "
                        "the kernels' plain versions)")
    s.set_defaults(fn=cmd_train)

    s = sub.add_parser("extract-features")
    s.add_argument("--csv", required=True)
    s.add_argument("--data_root", default="")
    s.add_argument("--image_size", type=int, default=256)
    s.add_argument("--num_frames", type=int, default=0,
                   help="0 = image dataset (AutoencoderKL), else frames a "
                        "clip (VideoAutoencoderKL)")
    s.add_argument("--batch_size", type=int, default=4)
    s.add_argument("--vae_ckpt", default=None,
                   help="the VAE's params file (.pt); else JAX's "
                        "initialisers from seed 0")
    s.add_argument("--save_dir", default="outputs/features")
    s.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the VAE (the card; 'cpu' for the "
                        "CPU)")
    s.set_defaults(fn=cmd_extract_features)

    s = sub.add_parser("calibrate-ptqd-k")
    s.add_argument("--fp_trajectory", required=True)
    s.add_argument("--quant_trajectory", required=True)
    s.add_argument("--save_dir", default="outputs")
    s.set_defaults(fn=cmd_calibrate_ptqd_k)
    return p


def main(argv=None):
    """Run one command; returns what it wrote (paths, the sampling or
    calibration seconds; the analysis commands also their scores)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
