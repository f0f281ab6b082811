"""Timestep-wise mixed-precision (MP) quantized inference (port of
`viditq_tpu/pipelines/mixed_precision.py:26-559`).

The reference flips quantizer bitwidths inside the denoise loop
(`t2v/scripts/quant_txt2video_mp.py:188-556`, `gaussian_diffusion.py:
740-767`): a bitwidth-config YAML gives per-layer bits for each range of
sampler steps. Two forms run it here, as in the JAX package:

* gather (`build_mp_sampler_gather`, native plans with momentum channel
  balancing and 8-bit dynamic acts): the union of the CB timeranges and the
  MP step ranges (as original-timestep spans) becomes the model's
  timerange partition; every quantized layer packs one int8 slab per union
  span at that span's bits, with per-span dequant tables (`mp_bits`,
  `QuantLinear.w_mp_scale`). One model serves the whole schedule: each
  forward's `QuantCtx.t_id` selects its span, and the layer reads the
  span's slab as a view `w_int[tr]`, so no step copies weights (the JAX
  package had to slice the slabs per span offline to avoid that copy,
  `static_segments`, and keeps a switch for it; the port has this one
  form);
* segmented (`build_mp_sampler` where the gather path does not take
  the configs: no CB, static or varying acts, the simulate backend): each
  step range runs `IDDPM.denoise_range` on a model of its own resolver,
  which shares the base model's parameters and calibrated tables (weight
  tables, CB tables, AdaRound's `w_alpha`, static act tables) and, under
  `native_repack` (a native plan), packs its slabs at the range's bits
  just before its steps; a simulate plan's ranges fake-quantize from the
  shared tables at their bits. The range's model is released after its
  steps, so no range holds fp weights of its own, and every call builds
  (and packs) each range's model again.

Both take a base model calibrated at the plan's bits (every bitwidth of
`mixed_precision`; under CB its act statistics, under static acts its act
tables too), and the act slot map of static act tables (`act_slot_map`,
from `run_ptq` or a quant checkpoint's meta). JAX's `static_segments`
switch (a TPU bisect form of the gather path) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from viditq_tpu_torch.pipelines.analysis import (mp_overrides_for_range,
                                                 parse_mp_ranges,
                                                 strip_model_prefix)
from viditq_tpu_torch.pipelines.inference import quant_sample
from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
from viditq_tpu_torch.quant.naming import any_pattern_in, pattern_in
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.quant.qlinear import QuantLinear
from viditq_tpu_torch.samplers.iddpm import IDDPM, default_qctx_factory

# model_ctor(resolver) -> a model of the workload under that resolver, on
# the device the run uses (e.g. `utils/workload.build_model`)
ModelCtor = Callable[[Callable], nn.Module]


def _check_tiling(w_ranges, n: int) -> None:
    """The weight ranges must tile the n-step schedule: a gap would skip
    denoising steps, an overlap run them twice (mixed_precision.py:40-49)."""
    covered = []
    for (hi, lo), _ in w_ranges:
        covered.extend(range(min(hi, n - 1), lo - 1, -1))
    if sorted(covered, reverse=True) != list(range(n - 1, -1, -1)):
        raise ValueError(
            f"mixed-precision step ranges {[r for r, _ in w_ranges]} do "
            f"not tile the {n}-step sampler schedule (covered: "
            f"{sorted(set(covered), reverse=True)})")


def _fp_extra(mp_weight_cfg: Mapping) -> Tuple[str, ...]:
    return tuple(strip_model_prefix(p)
                 for p in (mp_weight_cfg.get("fp_layers", ()) or ()))


def _build_segments(sampler: IDDPM, plan, mp_weight_cfg: Mapping,
                    mp_act_cfg: Optional[Mapping]):
    """Parse and validate the MP range configs: [(resolver, step_indices)]
    in sampling order, each resolver the plan with the range's bits as
    overrides and the config's `fp_layers` disabled (mixed_precision.py:
    26-79; the JAX function also builds each range's model, which the port
    builds when the range runs)."""
    w_ranges = parse_mp_ranges(mp_weight_cfg)
    a_ranges = dict(parse_mp_ranges(mp_act_cfg or {}))
    n = sampler.schedule.n_steps
    _check_tiling(w_ranges, n)
    # act ranges are matched per weight range by exact (hi, lo) key
    stray = set(a_ranges) - {r for r, _ in w_ranges}
    if stray:
        raise ValueError(
            f"act mixed-precision ranges {sorted(stray)} have no matching "
            f"weight range — their bit overrides would be silently dropped")
    fp = plan.fp_patterns + _fp_extra(mp_weight_cfg)
    segments = []
    for (hi, lo), w_bits in w_ranges:
        plan_r = plan.resolver(mp_overrides_for_range(
            w_bits, a_ranges.get((hi, lo)), plan.default_layer))

        def resolver(name, _r=plan_r):
            spec = _r(name)
            return spec.disabled() if any_pattern_in(name, fp) else spec
        segments.append((resolver, list(range(min(hi, n - 1), lo - 1, -1))))
    return segments


def _mp_tspans(sampler: IDDPM, w_ranges):
    """MP sampler-step ranges -> contiguous original-timestep spans,
    ascending in t, and each span's layer-bits dict (mixed_precision.py:
    82-100). The boundary between adjacent ranges is the midpoint of the
    neighbouring steps' original timesteps."""
    tmap = np.asarray(sampler.schedule.timestep_map)
    n = sampler.schedule.n_steps
    spans, bits = [], []
    prev_hi_t = -1
    for (hi, lo), layer_bits in sorted(w_ranges, key=lambda r: r[0][1]):
        hi = min(hi, n - 1)
        hi_t = (1000 if hi >= n - 1
                else (int(tmap[hi]) + int(tmap[hi + 1])) // 2)
        spans.append((prev_hi_t + 1, hi_t))
        bits.append(layer_bits)
        prev_hi_t = hi_t
    return spans, bits


def _union_partition(mp_spans, cb_spans):
    """Finest common refinement of two contiguous partitions of [0, 1000]:
    (spans ascending, the MP span of each, the CB span of each)
    (mixed_precision.py:103-120)."""
    cuts = sorted({hi for _, hi in mp_spans} | {hi for _, hi in cb_spans})
    spans, lo = [], 0
    for hi in cuts:
        spans.append((lo, hi))
        lo = hi + 1

    def idx_of(part, t):
        for i, (l, h) in enumerate(part):
            if l <= t <= h:
                return i
        raise ValueError(f"t={t} outside partition {part}")

    return (spans, [idx_of(mp_spans, l) for l, _ in spans],
            [idx_of(cb_spans, l) for l, _ in spans])


def _kind(name: str) -> str:
    """A layer's kind: its dotted name without index, wildcard and range
    segments ('blocks.5.attn.q' -> 'blocks.attn.q')."""
    return ".".join(s for s in name.split(".")
                    if not (s.isdigit() or s == "*"
                            or (s.startswith("[") and s.endswith("]"))))


def _bits_for(range_map: Mapping[str, int], name: str, default: int) -> int:
    """A layer's bits in one range: its exact key, else the first pattern
    that matches it (a module prefix 'blocks.5.attn' covers its linears),
    else the default (mixed_precision.py:204-216)."""
    v = range_map.get(name)
    if v is not None:
        return v
    for pat, b in range_map.items():
        if pattern_in(name, pat):
            return b
    return default


def _quant_key(spec):
    """What a layer spec quantizes, with its per-range weight bits."""
    return (spec.weight_quant, spec.act_quant,
            spec.weight.mp_bits if spec.weight is not None else None)


def share_parameters(dst: nn.Module, src: nn.Module) -> nn.Module:
    """Make dst's parameters src's own Parameter objects (one fp weight set
    for both; dst's were allocated by its constructor and are released
    here). The two models have one architecture: equal parameter names."""
    for name, p in src.named_parameters():
        owner, _, leaf = name.rpartition(".")
        setattr(dst.get_submodule(owner) if owner else dst, leaf, p)
    return dst


class GatherMPSampler:
    """The union-packed MP sampler (`build_mp_sampler_gather`): call it as
    `run(model, z, y, mask)` on the calibrated base (CB) model or on what
    `prepare` returned; DDIM with CFG over the sampler's schedule, as
    `quant_sample`."""

    def __init__(self, model_ctor: ModelCtor, sampler: IDDPM, resolver,
                 spans, mp_idx, cb_idx):
        self.model_ctor = model_ctor
        self.sampler = sampler
        self.resolver = resolver
        self.spans = tuple(spans)
        self.mp_idx = tuple(mp_idx)
        self.cb_idx = tuple(cb_idx)
        self.n_ranges = len(spans)
        self._src = self._prepared = None

    def is_prepared(self, model: nn.Module) -> bool:
        """Whether model already runs on the union partition at the union
        plan's bits (JAX: its quant leaves, the `w_mp_*` tables included,
        have the union template's shapes): every CB layer's timeranges are
        the union spans, and every layer built from a spec quantizes as
        the resolver says, with its `mp_bits`. A base model whose CB
        timeranges equal the union spans (every MP cut on a CB cut) is
        adapted all the same where the MP ranges change a layer's bits."""
        layers = [(n, m) for n, m in model.named_modules()
                  if isinstance(m, QuantLinear) and m.lspec is not None]
        cb = [m for _, m in layers if m.smooth is not None]
        return (bool(cb) and all(m.smooth.timerange == self.spans
                                 for m in cb)
                and all(_quant_key(m.lspec) == _quant_key(self.resolver(n))
                        for n, m in layers))

    @torch.no_grad()
    def prepare(self, model: nn.Module) -> nn.Module:
        """The union-plan model of a calibrated base model (JAX
        `run.prepare(variables, z, y, mask)`, whose inputs only shape its
        variable template): built by model_ctor, sharing the base's
        parameters, each layer's act statistics gathered by CB span
        (`_union_q`), then
        calibrated (cb_scale per union span with its CB range's alpha;
        tables at every bitwidth) and packed at each span's bits. A union
        model passes through; the last base model's union model is kept
        (held by the base object itself, not its id)."""
        if self.is_prepared(model):
            return model
        if self._src is not model:
            self._src = self._prepared = None
            union = share_parameters(self.model_ctor(self.resolver), model)
            base = dict(model.named_modules())
            for name, mod in union.named_modules():
                if isinstance(mod, QuantLinear) and mod.smooth is not None:
                    src = base[name].act_scale
                    mod.act_scale.copy_(src[torch.tensor(
                        self.cb_idx, device=src.device)])
            calibrate_weight_tables(union)
            pack_native_weights(union).eval()
            self._src, self._prepared = model, union
        return self._prepared

    def __call__(self, model: nn.Module, z, y, mask=None):
        return quant_sample(self.prepare(model), self.sampler, z, y, mask)


def build_mp_sampler_gather(model_ctor: ModelCtor, sampler: IDDPM, plan,
                            mp_weight_cfg: Mapping,
                            mp_act_cfg: Optional[Mapping]
                            ) -> Optional[GatherMPSampler]:
    """The union-packed MP sampler of a native momentum-CB plan with 8-bit
    dynamic acts (mixed_precision.py:127-478); None where the configs are
    not representable on this path: a non-native plan, static acts or acts
    other than 8 bits, varying act bits, CB off or not momentum, bits
    outside the calibrated `mixed_precision` list. A gapped or overlapping
    weight tiling raises ValueError. Every layer kind overridden in some
    range carries `mp_bits` in every block. Static acts take the segmented
    path, which carries their slot map."""
    base = plan.default_layer
    if not (plan.uses_native() and base.weight is not None
            and base.weight_quant and base.act_quant
            and base.act is not None and base.act.dynamic
            and base.act.n_bits == 8 and base.smooth_quant.enable
            and "momentum" in base.smooth_quant.channel_wise_scale_type):
        return None
    w_ranges = parse_mp_ranges(mp_weight_cfg)
    if not w_ranges:
        return None
    _check_tiling(w_ranges, sampler.schedule.n_steps)
    for _, layer_bits in parse_mp_ranges(mp_act_cfg or {}):
        if any(b != base.act.n_bits for b in layer_bits.values()):
            return None  # varying act bits: the segmented path
    avail = base.weight.bits_tuple
    for _, layer_bits in w_ranges:
        if any(b not in avail for b in layer_bits.values()):
            return None

    mp_spans, mp_bits_dicts = _mp_tspans(sampler, w_ranges)
    smooth = base.smooth_quant
    spans, mp_idx, cb_idx = _union_partition(mp_spans,
                                             list(smooth.timerange))
    new_smooth = dataclasses.replace(
        smooth, timerange=tuple(spans),
        alpha=tuple(smooth.alpha_for_range(ci) for ci in cb_idx))
    base_resolve = dataclasses.replace(
        plan, default_layer=dataclasses.replace(
            base, smooth_quant=new_smooth)).resolver()
    range_bits = [{strip_model_prefix(k): v for k, v in d.items()}
                  for d in mp_bits_dicts]
    fp_extra = _fp_extra(mp_weight_cfg)
    kind_pats = {_kind(n) for d in range_bits for n in d}

    def resolver(name: str):
        spec = base_resolve(name)
        if fp_extra and any_pattern_in(name, fp_extra):
            return spec.disabled()
        if spec.weight is not None and spec.weight_quant:
            bits = tuple(_bits_for(range_bits[mi], name, spec.weight.n_bits)
                         for mi in mp_idx)
            if (any(b != spec.weight.n_bits for b in bits)
                    or any(pattern_in(_kind(name), kp) for kp in kind_pats)):
                spec = dataclasses.replace(
                    spec, weight=dataclasses.replace(spec.weight,
                                                     mp_bits=bits))
        return spec

    return GatherMPSampler(model_ctor, sampler, resolver, spans, mp_idx,
                           cb_idx)


class SegmentedMPSampler:
    """The per-range MP sampler (`build_mp_sampler`'s fallback): call it as
    `run(model, z, y, mask)` on a base model calibrated at every bitwidth
    of the plan's `mixed_precision`. Each range's model shares the base's
    parameters and takes its calibrated tables (the JAX segments share one
    `variables` tree, mixed_precision.py:521-541); with `native_repack`
    (`build_mp_sampler` sets it to `plan.uses_native()`) its slabs are
    packed at the range's bits, else (the simulate backend) it
    fake-quantizes from the shared tables. Every forward's context
    takes its static act slot from `act_slot_map` (JAX
    `default_qctx_factory(act_slot_map=)`, :521). Each call builds every
    range's model (and packs its slabs) again: nothing is kept between
    calls."""

    # the calibrated tables a range's model takes from the base model: the
    # weight and CB tables, AdaRound's rounding, the static act tables
    TABLES = ("w_delta", "w_zp", "w_alpha", "act_scale", "cb_scale",
              "a_delta", "a_zp", "a_min", "a_max", "a_init")

    def __init__(self, model_ctor: ModelCtor, sampler: IDDPM,
                 segments: Sequence[Tuple[Callable, List[int]]],
                 act_slot_map=None, native_repack: bool = True):
        self.model_ctor = model_ctor
        self.sampler = sampler
        self.segments = list(segments)
        self.act_slot_map = act_slot_map
        self.native_repack = native_repack

    @torch.no_grad()
    def __call__(self, model: nn.Module, z, y, mask=None):
        tables = {k: v for k, v in model.state_dict().items()
                  if k.rpartition(".")[2] in self.TABLES}
        qf = default_qctx_factory("quant", act_slot_map=self.act_slot_map)
        x2 = torch.cat([z, z], dim=0)
        for resolver, steps in self.segments:
            seg = share_parameters(self.model_ctor(resolver), model).eval()
            own = seg.state_dict()
            seg.load_state_dict({k: v for k, v in tables.items()
                                 if k in own}, strict=False)
            if self.native_repack:
                pack_native_weights(seg)
            x2 = self.sampler.denoise_range(seg, x2, y, mask, steps,
                                            qctx_factory=qf)
            del seg
        return torch.chunk(x2, 2, dim=0)[0]


def build_mp_sampler(model_ctor: ModelCtor, sampler: IDDPM, plan,
                     mp_weight_cfg: Mapping, mp_act_cfg: Optional[Mapping],
                     act_slot_map=None):
    """An MP sampler, `run(model, z, y, mask)` (mixed_precision.py:
    480-546): the gather path where `build_mp_sampler_gather` represents
    the configs (its union model is built once and kept), else the
    segmented path (which builds each range's model on every call and, on
    a native plan, packs its slabs). `act_slot_map`: the static act
    tables' slot of each timestep."""
    run = build_mp_sampler_gather(model_ctor, sampler, plan, mp_weight_cfg,
                                  mp_act_cfg)
    if run is not None:
        return run
    return SegmentedMPSampler(model_ctor, sampler, _build_segments(
        sampler, plan, mp_weight_cfg, mp_act_cfg), act_slot_map,
        plan.uses_native())


def mp_quant_sample(model_ctor: ModelCtor, model: nn.Module, sampler: IDDPM,
                    z, y, mask, plan, mp_weight_cfg: Mapping,
                    mp_act_cfg: Optional[Mapping], act_slot_map=None):
    """Generate with per-step-range bit allocation, one-shot
    (mixed_precision.py:549-559); for repeated generation build once with
    `build_mp_sampler`."""
    return build_mp_sampler(model_ctor, sampler, plan, mp_weight_cfg,
                            mp_act_cfg, act_slot_map=act_slot_map)(
                                model, z, y, mask)
