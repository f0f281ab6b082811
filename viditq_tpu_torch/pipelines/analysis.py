"""Offline quantization analysis (port of `viditq_tpu/pipelines/
analysis.py:37-424, 452-489`): the reference's analysis scripts as library
functions.

  * sensitivity: `t2v/scripts/get_sensitivity.py`: quantize one {layer
    group | block x group x timestep window} at a time, generate, score
    against the fp generation (`utils/metrics.make_sensitivity_metric`);
    several metrics rank-combined (`combine_sensitivity`), and the
    bitwidth config they give (`generate_mp_config`);
  * sweep alpha: `t2v/scripts/sweep_alpha.py`: each layer's best
    smooth-quant alpha by the quantized output's MSE on its captured
    input;
  * smooth-quant list: `t2v/scripts/get_smooth_quant_list.py`: the layers
    whose act channel ranges are imbalanced;
  * the timestep-wise mixed-precision configs (reference `t20_*_mp.yaml`):
    step ranges in sampling order and per-layer spec overrides.

A layer's input is captured by a forward pre-hook on each `QuantLinear`
that quantizes something (the layers whose flax `sow` the JAX capture
reads, qlinear.py:480-481), keyed by its dotted name; the hook runs the
layer's statistic as the input arrives and keeps only the result, so a
full-size model never holds every input at once. The layout-native STDiT
hands some layers their rows in another order than the JAX model; every
statistic here is over rows, so the order does not matter.

  * PTQD: `calibrate_ptqd_k`, the per-step correlated-noise coefficient
    of matched fp and quantized trajectories (reference
    calibrate_ptqd_k.py:220-272), and `apply_ptqd_correction`, the opt-in
    division of a model output by (1 + k_t) (JAX analysis.py:423-447).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from viditq_tpu_torch.quant import core
from viditq_tpu_torch.quant.naming import pattern_in
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.quant.spec import LayerQuantSpec
from viditq_tpu_torch.utils.metrics import frame_mse

# the reference's group taxonomy (get_sensitivity.py:133-134)
QUANT_GROUPS = ("attn", "cross_attn", "mlp", "attn_temp")


def _fp(name: str, fp_patterns: Sequence[str]) -> bool:
    return any(pattern_in(name, p) for p in fp_patterns)


def single_target_resolver(base: LayerQuantSpec, target_pattern: str,
                           fp_patterns: Sequence[str] = ()):
    """Quantize only the layers matching target_pattern (reference
    set_layer_quant / group_set_quant, quant_model.py:433-490)."""
    def resolve(name: str) -> Optional[LayerQuantSpec]:
        if pattern_in(name, target_pattern) and not _fp(name, fp_patterns):
            return base
        return base.disabled()
    return resolve


def partial_quant_resolver(base: LayerQuantSpec, layer_names: Sequence[str],
                           quant_ratio: float, seed: int = 0,
                           fp_patterns: Sequence[str] = ()):
    """Quantize a random fraction of the layers (reference `--part_quant
    / --quant_ratio`, config_utils.py:11-178): the same numpy draws as
    JAX."""
    rng = np.random.default_rng(seed)
    eligible = [n for n in layer_names if not _fp(n, fp_patterns)]
    k = int(round(len(eligible) * quant_ratio))
    chosen = set(rng.choice(eligible, size=k, replace=False)) if k else set()

    def resolve(name: str) -> Optional[LayerQuantSpec]:
        return base if name in chosen else base.disabled()
    return resolve


def quantize_until_resolver(base: LayerQuantSpec,
                            ordered_names: Sequence[str], k: int,
                            fp_patterns: Sequence[str] = ()):
    """Quantize only the first k layers in forward order (reference
    `quantize_model_till`, qdiff/utils.py:588)."""
    chosen = set(ordered_names[:k])

    def resolve(name: str) -> Optional[LayerQuantSpec]:
        if name in chosen and not _fp(name, fp_patterns):
            return base
        return base.disabled()
    return resolve


def sensitivity_scan(run_with_resolver: Callable, base: LayerQuantSpec,
                     targets: Sequence[str],
                     fp_patterns: Sequence[str] = (),
                     fp_reference=None,
                     metric_fn: Callable = frame_mse) -> Dict[str, float]:
    """For each target pattern, generate with only that target quantized
    and score metric_fn(out, fp_reference). run_with_resolver(resolver)
    -> the generated sample; the fp reference is its run with nothing
    quantized (a resolver returning None)."""
    if fp_reference is None:
        fp_reference = run_with_resolver(lambda name: None)
    scores = {}
    for tgt in targets:
        out = run_with_resolver(single_target_resolver(base, tgt,
                                                       fp_patterns))
        scores[tgt] = float(metric_fn(out, fp_reference))
    return scores


def sensitivity_scan_multi(run_with_resolver: Callable,
                           base: LayerQuantSpec, targets: Sequence[str],
                           metric_fns: Mapping[str, Callable],
                           fp_patterns: Sequence[str] = (),
                           fp_reference=None
                           ) -> Dict[str, Dict[str, float]]:
    """`sensitivity_scan` under several metrics from one generation per
    target: {metric: {target: score}} (the reference's clip / flow / vqa
    vectors, qdiff/analysis_tools/mixed_precision/sensitivity/*)."""
    if fp_reference is None:
        fp_reference = run_with_resolver(lambda name: None)
    scores: Dict[str, Dict[str, float]] = {m: {} for m in metric_fns}
    for tgt in targets:
        out = run_with_resolver(single_target_resolver(base, tgt,
                                                       fp_patterns))
        for m, fn in metric_fns.items():
            scores[m][tgt] = float(fn(out, fp_reference))
    return scores


def combine_sensitivity(metric_vectors: Mapping[str, Mapping[str, float]],
                        weights: Optional[Mapping[str, float]] = None
                        ) -> Dict[str, float]:
    """One ranking from per-metric vectors (the reference's metric.ipynb
    combination): each metric's scores rank-normalised to [0, 1], then
    averaged with the weights; a layer a metric lacks scores 0 there."""
    layers = sorted({n for v in metric_vectors.values() for n in v})
    if not layers:
        return {}
    w = {m: 1.0 for m in metric_vectors} if weights is None else dict(weights)
    total_w = sum(w.get(m, 0.0) for m in metric_vectors) or 1.0
    combined = {n: 0.0 for n in layers}
    for m, vec in metric_vectors.items():
        ranked = sorted(vec, key=lambda n: vec[n])
        denom = max(len(ranked) - 1, 1)
        rank01 = {n: i / denom for i, n in enumerate(ranked)}
        for n in layers:
            combined[n] += w.get(m, 0.0) * rank01.get(n, 0.0)
    return {n: s / total_w for n, s in combined.items()}


def _segmented_sample(sampler, fp_apply, q_apply, z, y, mask, hi, lo,
                      qctx_factory):
    """One DDIM generation with q_apply inside spaced steps [lo, hi] and
    fp_apply outside (the reference's mid-loop quant-state flips,
    gaussian_diffusion.py:691-738)."""
    n = sampler.schedule.n_steps
    x2 = torch.cat([z, z], dim=0)
    if hi < n - 1:
        x2 = sampler.denoise_range(fp_apply, x2, y, mask,
                                   list(range(n - 1, hi, -1)))
    x2 = sampler.denoise_range(q_apply, x2, y, mask,
                               list(range(hi, lo - 1, -1)),
                               qctx_factory=qctx_factory)
    if lo > 0:
        x2 = sampler.denoise_range(fp_apply, x2, y, mask,
                                   list(range(lo - 1, -1, -1)))
    return torch.chunk(x2, 2, dim=0)[0]


def timestep_window_sensitivity(sampler, fp_apply, q_apply, z, y, mask,
                                windows, qctx_factory, fp_reference=None,
                                metric_fn: Callable = frame_mse
                                ) -> Dict[str, float]:
    """Quantized inside each window [(hi, lo)] of sampler steps
    (descending), fp outside (reference timestep_wise_quant windows)."""
    if fp_reference is None:
        fp_reference = sampler.sample(fp_apply, z, y, mask)
    scores = {}
    for hi, lo in windows:
        out = _segmented_sample(sampler, fp_apply, q_apply, z, y, mask,
                                hi, lo, qctx_factory)
        scores[f"{hi}-{lo}"] = float(metric_fn(out, fp_reference))
    return scores


def uniform_windows(n_steps: int, split_timestep: int = 4
                    ) -> List[Tuple[int, int]]:
    """The block-group mode's uniform timestep split (get_sensitivity.py:
    480, 727-731), descending."""
    qtl = [i * n_steps // split_timestep for i in range(split_timestep)]
    size = n_steps // split_timestep
    return [(qtl[k] + size - 1, qtl[k])
            for k in range(split_timestep - 1, -1, -1)]


def spec_with_bits(base: LayerQuantSpec, n_bits: int) -> LayerQuantSpec:
    """Weight and act reset to one bitwidth (reference set_layer_bit
    'reset' pairs, get_sensitivity.py:469-470)."""
    w = (dataclasses.replace(base.weight, n_bits=n_bits)
         if base.weight is not None else None)
    a = (dataclasses.replace(base.act, n_bits=n_bits)
         if base.act is not None else None)
    return dataclasses.replace(base, weight=w, act=a)


def block_group_resolver(base: LayerQuantSpec, block_idx: int, group: str,
                         fp_patterns: Sequence[str] = ()):
    """Quantize only the layers of block block_idx matching group
    (get_sensitivity.py:491-501)."""
    def resolve(name: str) -> Optional[LayerQuantSpec]:
        if (pattern_in(name, f"blocks.{block_idx}")
                and pattern_in(name, group) and not _fp(name, fp_patterns)):
            return base
        return base.disabled()
    return resolve


def block_group_sensitivity(sampler, fp_apply, make_q_apply, z, y, mask,
                            base: LayerQuantSpec, n_blocks: int,
                            qctx_factory, groups: Sequence[str] = ("attn",),
                            bits: Sequence[int] = (8,),
                            split_timestep: int = 4,
                            fp_patterns: Sequence[str] = (),
                            fp_reference=None,
                            metric_fn: Callable = frame_mse
                            ) -> Dict[str, float]:
    """block x group x timestep-window sensitivity (the reference's
    block_group_wise_quant mode, get_sensitivity.py:467-521, 727-741):
    {"bit{b}/{hi}-{lo}/blocks.{j}.{group}": score}. make_q_apply(resolver)
    -> a model apply with that quant layout."""
    if fp_reference is None:
        fp_reference = sampler.sample(fp_apply, z, y, mask)
    windows = uniform_windows(sampler.schedule.n_steps, split_timestep)
    scores: Dict[str, float] = {}
    for b in bits:
        spec_b = spec_with_bits(base, b)
        for j in range(n_blocks):
            for g in groups:
                q_apply = make_q_apply(
                    block_group_resolver(spec_b, j, g, fp_patterns))
                for hi, lo in windows:
                    out = _segmented_sample(sampler, fp_apply, q_apply,
                                            z, y, mask, hi, lo,
                                            qctx_factory)
                    key = f"bit{b}/{hi}-{lo}/blocks.{j}.{g}"
                    scores[key] = float(metric_fn(out, fp_reference))
    return scores


def block_group_to_range_scores(scores: Mapping[str, float],
                                bit: Optional[int] = None
                                ) -> Dict[str, Dict[str, float]]:
    """block_group_sensitivity's scores as {range: {layer: score}}, the
    input of `generate_mp_config`."""
    out: Dict[str, Dict[str, float]] = {}
    for key, v in scores.items():
        bpart, rng_key, layer = key.split("/")
        if bit is not None and bpart != f"bit{bit}":
            continue
        out.setdefault(rng_key, {})[layer] = v
    return out


# ---------------- layer-input statistics ----------------

@torch.no_grad()
def capture_layer_stats(model, example_args, stat: Callable,
                        mode: str = "fp") -> Dict[str, object]:
    """One forward of the model on example_args (x, t, y, mask) in `mode`;
    {dotted layer name: stat(name, layer, input)} for every QuantLinear
    that quantizes something, at its first call (flax `sow`'s first
    value)."""
    names = {m: n for n, m in model.named_modules()
             if isinstance(m, QuantLinear) and m.path is not None}
    out: Dict[str, object] = {}

    def hook(mod, args):
        name = names[mod]
        if name not in out and args and args[0] is not None:
            out[name] = stat(name, mod, args[0])
    handles = [m.register_forward_pre_hook(hook) for m in names]
    try:
        model(*example_args, qctx=QuantCtx(mode=mode))
    finally:
        for h in handles:
            h.remove()
    return out


def capture_layer_inputs(model, example_args, mode: str = "fp"
                         ) -> Dict[str, torch.Tensor]:
    """{dotted layer name: its input} of one forward (JAX
    `capture_layer_inputs`)."""
    return capture_layer_stats(model, example_args,
                               lambda name, mod, x: x.detach().clone(), mode)


@torch.no_grad()
def sweep_alpha_for_layer(x: torch.Tensor, kernel: torch.Tensor,
                          lspec: LayerQuantSpec,
                          alphas: Optional[np.ndarray] = None
                          ) -> Tuple[float, Dict[float, float]]:
    """The smooth-quant alpha of least quantized-output MSE for one layer,
    over the reference grid 0.475 -> 0.9 step 0.01 (sweep_alpha.py:
    259-270). x: the layer's input [..., C_in]; kernel [C_in, F]."""
    if alphas is None:
        alphas = np.arange(0.475, 0.9, 0.01)
    x = x.reshape(-1, x.shape[-1]).float()
    kernel = kernel.float()
    ref = x @ kernel
    a_absmax = x.abs().amax(dim=0)
    w_absmax = kernel.abs().amax(dim=-1)
    wspec, aspec = lspec.weight, lspec.act

    def loss_for(alpha: float) -> float:
        cs = core.smooth_quant_scale(a_absmax, w_absmax, alpha)
        xb = x / cs
        wb = kernel * cs[:, None]
        wd, wz = core.compute_qparams(wb, wspec)
        wq = core.fake_quant(wb, wd, wz, wspec)
        xq = core.fake_quant_dynamic(xb[None], aspec)[0] if aspec else xb
        return float(((xq @ wq - ref) ** 2).mean())

    losses = {round(float(a), 4): loss_for(float(a)) for a in alphas}
    best = min(losses, key=losses.get)
    return best, losses


def sweep_alpha(model, example_args, resolver,
                alphas: Optional[np.ndarray] = None) -> Dict[str, float]:
    """{layer: best alpha} of every weight-quantized layer (reference
    sweep_alpha.py's output), each swept as its input arrives."""
    def stat(name, mod, x):
        lspec = resolver(name)
        if lspec is None or not lspec.weight_quant:
            return None
        return sweep_alpha_for_layer(x, mod.kernel, lspec, alphas)[0]
    best = capture_layer_stats(model, example_args, stat)
    return {k: v for k, v in best.items() if v is not None}


def act_range_ratio(x: torch.Tensor) -> float:
    """max over channels of the channel's |x| max, over their median
    (get_smooth_quant_list.py:70-110)."""
    xf = x.reshape(-1, x.shape[-1]).float().abs()
    ch_max = torch.clamp(xf.amax(dim=0), min=1e-9)
    # the median as numpy takes it: the mean of the two middle values of
    # an even count (torch.median returns the lower one)
    srt = ch_max.sort().values
    n = srt.numel()
    med = (srt[(n - 1) // 2] + srt[n // 2]) / 2
    return float(ch_max.max() / torch.clamp(med, min=1e-9))


def smooth_quant_candidates(model, example_args, resolver,
                            act_ratio_threshold: float = 10.0) -> List[str]:
    """The layers whose act channel ranges are imbalanced: range ratio
    above the threshold, in forward order (the CB shortlist)."""
    ratios = capture_layer_stats(
        model, example_args, lambda name, mod, x: act_range_ratio(x))
    return [n for n, r in ratios.items()
            if resolver(n) is not None and r > act_ratio_threshold]


def generate_mp_config(sensitivity: Mapping[str, Mapping[str, float]],
                       bits_low: int = 4, bits_high: int = 8,
                       high_fraction: float = 0.25,
                       fp_fraction: float = 0.0) -> Dict:
    """A timestep-wise bitwidth config from per-range per-layer scores
    {'19-15': {layer: score}} (higher = more sensitive): per range the
    most sensitive high_fraction get bits_high, the fp_fraction tail goes
    to fp_layers, the rest bits_low (the role of metric.ipynb cell 3)."""
    out: Dict = {"fp_layers": []}
    fp_set = set()
    for rng_key, scores in sensitivity.items():
        ranked = sorted(scores, key=scores.get, reverse=True)
        n = len(ranked)
        n_fp = int(n * fp_fraction)
        n_high = int(n * high_fraction)
        alloc = {}
        for i, name in enumerate(ranked):
            if i < n_fp:
                fp_set.add(name)
            elif i < n_fp + n_high:
                alloc[name] = bits_high
            else:
                alloc[name] = bits_low
        out[rng_key] = alloc
    out["fp_layers"] = sorted(fp_set)
    return out


# ---------------- timestep-wise mixed precision ----------------

def strip_model_prefix(name: str) -> str:
    """The reference's `model.blocks.0.attn.q` -> the port's
    `blocks.0.attn.q`."""
    return name[6:] if name.startswith("model.") else name


def mp_overrides_for_range(mp_weight: Mapping[str, int],
                           mp_act: Optional[Mapping[str, int]],
                           base: LayerQuantSpec
                           ) -> Dict[str, LayerQuantSpec]:
    """Per-layer LayerQuantSpec overrides of one range ({'model.blocks.0.
    attn.q': 4, ...}; reference load_bitwidth_config, quant_model.py:
    562-586), keyed by the name without its `model.` prefix. Weight bits
    go through `QuantSpec.with_bits` (refused for a static quantizer's
    uncalibrated bitwidth); act bits too (a dynamic act switches
    freely)."""
    overrides: Dict[str, LayerQuantSpec] = {}
    mp_act = mp_act or {}
    for name in set(mp_weight) | set(mp_act):
        spec = base
        wb = mp_weight.get(name)
        ab = mp_act.get(name)
        if wb is not None and spec.weight is not None:
            spec = dataclasses.replace(spec, weight=spec.weight.with_bits(wb))
        if ab is not None and spec.act is not None:
            spec = dataclasses.replace(spec, act=spec.act.with_bits(ab))
        overrides[strip_model_prefix(name)] = spec
    return overrides


def parse_mp_ranges(mp_cfg: Mapping) -> List[Tuple[Tuple[int, int], Dict]]:
    """'19-15'-style sampler-step ranges -> [((hi, lo), layer_bits)] sorted
    by hi, descending (sampling order); 'fp_layers' and other non-mapping
    entries are skipped."""
    out = []
    for key, val in mp_cfg.items():
        if key == "fp_layers" or not isinstance(val, Mapping):
            continue
        hi, lo = (int(v) for v in key.split("-"))
        out.append(((hi, lo), dict(val)))
    return sorted(out, key=lambda r: -r[0][0])


# ---------------- PTQD ----------------

def calibrate_ptqd_k(fp_outs, quant_outs) -> np.ndarray:
    """Per-step correlated-noise coefficient k_t, float32 [n_steps]:
    fp_outs / quant_outs [n_steps, ...] are the model eps outputs of matched
    fp and quantized trajectories; quant noise is modelled as (1 + k) * fp
    plus an uncorrelated part, k the least-squares fit per step in float64
    (JAX analysis.py:423-439)."""
    ks = []
    for f, q in zip(fp_outs, quant_outs):
        f = np.asarray(f, np.float64).ravel()
        q = np.asarray(q, np.float64).ravel()
        ks.append(float(q @ f) / (float(f @ f) + 1e-12) - 1.0)
    return np.asarray(ks, np.float32)


def apply_ptqd_correction(model_out: torch.Tensor, k_t, step_idx
                          ) -> torch.Tensor:
    """The opt-in PTQD correction: model_out / (1 + k_t[step_idx]) (JAX
    analysis.py:442-447)."""
    k = torch.as_tensor(np.asarray(k_t), device=model_out.device)[step_idx]
    return model_out / (1.0 + k)
