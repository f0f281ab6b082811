"""Quant-config loading: the reference's YAML schema -> specs.

The port's copy of the plan surface of `viditq_tpu/utils/config.py`: parses
the YAML layout shipped by ViDiT-Q (`t2v/configs/quant/opensora/*.yaml`)
into the same frozen `QuantSpec`/`LayerQuantSpec` values the JAX package
resolves, plus a plain `QuantPlanConfig` whose `resolver()` maps dotted
layer names to specs (with the plan's per-group `backend_overrides`, the
hybrid plans), and the timestep-wise mixed-precision bitwidth YAMLs
(`load_bitwidth_config`). The reconstruction sections
(`quant.{weight,activation}.optimization`) are parsed into the plan's
`weight_opt` / `act_opt` (`OptimizationConfig`); a plan that asks for
reconstruction (`quant/reconstruction.wants_reconstruction`) gets
AdaRound block or layer reconstruction after `run_ptq` in the `ptq`
command (`quant/reconstruction.py`).
`resume_with_w_quantized` names a quant checkpoint whose weight tables
PTQ reuses (`pipelines/ptq.resume_w_quantized`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import yaml

from viditq_tpu_torch.quant.naming import (any_pattern_in, load_fp_list,
                                           pattern_in, resolve_layer_spec)
from viditq_tpu_torch.quant.spec import (LayerQuantSpec, QuantSpec,
                                         SmoothQuantSpec)


def _granularity(per_group) -> str:
    if per_group in (False, None, "False", "None"):
        return "tensor"
    if per_group in ("channel", "token"):
        return per_group
    if per_group == "group":
        # the reference's w6a6_smooth_quant.yaml says per_group: "group";
        # the intended semantics for a dynamic-act plan is per-token
        return "token"
    raise ValueError(f"unknown per_group {per_group!r}")


def parse_weight_spec(cfg: Dict[str, Any], mixed_precision=None) -> QuantSpec:
    q = cfg["quantizer"]
    return QuantSpec(
        n_bits=int(q["n_bits"]),
        granularity=_granularity(q.get("per_group", "channel")),
        channel_axis=-1,  # [C_in, C_out] kernel layout == torch channel_dim=0
        scale_method=q.get("scale_method", "min_max"),
        round_mode=q.get("round_mode", "nearest"),
        sym=bool(q.get("sym", False)),
        mixed_precision=tuple(mixed_precision) if mixed_precision else None,
    )


def parse_act_spec(cfg: Dict[str, Any], mixed_precision=None,
                   timestep_wise: bool = False,
                   n_timestep: int = 1) -> QuantSpec:
    q = cfg["quantizer"]
    dynamic = bool(q.get("dynamic", False))
    return QuantSpec(
        n_bits=int(q["n_bits"]),
        granularity=_granularity(q.get("per_group", False)),
        channel_axis=-1,
        scale_method=q.get("scale_method", "min_max"),
        round_mode=q.get("round_mode", "nearest_ste"),
        sym=bool(q.get("sym", False)),
        dynamic=dynamic,
        running_stat=bool(q.get("running_stat", False)),
        mixed_precision=(tuple(mixed_precision)
                         if (mixed_precision and not dynamic) else None),
        timestep_wise=bool(timestep_wise) and not dynamic,
        n_timestep=n_timestep if (timestep_wise and not dynamic) else 1,
    )


def parse_smooth_spec(cfg: Dict[str, Any]) -> SmoothQuantSpec:
    sq = (cfg.get("quantizer", {}) or {}).get("smooth_quant") or {}
    if not sq or not sq.get("enable", False):
        return SmoothQuantSpec()
    alpha = sq.get("alpha", 0.5)
    if not isinstance(alpha, (list, tuple)):
        alpha = (float(alpha),)
    else:
        alpha = tuple(float(a) for a in alpha)
    timerange = sq.get("timerange", [[0, 1000]])
    timerange = tuple(tuple(int(v) for v in r) for r in timerange)
    return SmoothQuantSpec(
        enable=True,
        channel_wise_scale_type=sq.get("channel_wise_scale_type",
                                       "momentum_act_max"),
        momentum=float(sq.get("momentum", 0.95)),
        alpha=alpha, timerange=timerange,
        frozen_tr0_weights=not bool(sq.get("corrected_tr_weight_tables",
                                           False)),
        qkv_share_cs=bool(sq.get("qkv_share_cs", False)))


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """A parsed `quant.{weight,activation}.optimization` section, the
    reference's reconstruction knobs (t2i/scripts/ptq.py:320-359; JAX
    config.py:96-120): a learning rate for the AdaRound alphas or the
    deltas turns reconstruction on."""

    iters: int = 2000
    lambda_coeff: float = 1.0
    warmup: float = 0.0
    alpha_lr: Optional[float] = None
    delta_lr: Optional[float] = None
    joint_weight_act: bool = False
    # 'layer' (reference model_recon) or 'block' (block_reconstruction)
    granularity: str = "layer"

    @property
    def enabled(self) -> bool:
        return self.alpha_lr is not None or self.delta_lr is not None


def parse_optimization(sec) -> Optional[OptimizationConfig]:
    """JAX config.py:123-140."""
    if not isinstance(sec, dict):
        return None
    loss = sec.get("loss") or {}
    params = sec.get("params") or {}

    def lr(name):
        p = params.get(name)
        return float(p["lr"]) if isinstance(p, dict) and "lr" in p else None
    return OptimizationConfig(
        iters=int(sec.get("iters", 2000)),
        lambda_coeff=float(loss.get("lambda_coeff", 1.0)),
        warmup=float(loss.get("warmup", 0.0)),
        alpha_lr=lr("alpha"), delta_lr=lr("delta"),
        joint_weight_act=bool(sec.get("joint_weight_act_opt", False)),
        granularity=str(sec.get("granularity", "layer")))


def _resume_w_path(sec) -> Optional[str]:
    """`resume_with_w_quantized: {path: ...}` (JAX config.py:343-347):
    None for the shipped configs' `path: None`."""
    p = sec.get("path") if isinstance(sec, dict) else sec
    if p in (None, "", "None", "none"):
        return None
    return str(p)


@dataclasses.dataclass(frozen=True)
class QuantPlanConfig:
    """One parsed quant YAML (the reference 'ptq_config'), as far as the
    port reads it: the default layer spec, the fp list, the per-group
    backend overrides, the scopes of the attention-internal quantizers,
    the sampler's `cfg_split` and the calibration keys
    (viditq_tpu/utils/config.py:143-177)."""

    default_layer: LayerQuantSpec
    fp_patterns: Tuple[str, ...] = ()
    # per-group execution overrides (pattern, mode), mode one of 'native',
    # 'fused', 'weight_only' or 'simulate': the hybrid plans (full int8 on
    # the MLPs, int8-stored weights with bf16 compute elsewhere)
    backend_overrides: Tuple[Tuple[str, str], ...] = ()
    cfg_split: bool = False
    mixed_precision: Optional[Tuple[int, ...]] = None
    timestep_wise: bool = False
    calib_n_steps: int = 10
    calib_batch_size: int = 4
    # restrict the attention-internal quantizers to matching layer-name
    # patterns (e.g. softmax int8 on the temporal/cross attentions only)
    softmax_scope: Tuple[str, ...] = ()
    attn_act_scope: Tuple[str, ...] = ()
    weight_opt: Optional[OptimizationConfig] = None
    act_opt: Optional[OptimizationConfig] = None
    # a prior quant checkpoint whose weight tables PTQ takes instead of
    # calibrating them (the YAML's resume_with_w_quantized.path; JAX
    # config.py:165-171)
    resume_w_path: Optional[str] = None

    def resolver(self, overrides: Optional[Mapping[str, LayerQuantSpec]]
                 = None):
        """Layer-name -> LayerQuantSpec resolver for model construction and
        offline calibration (same rules as the JAX package's,
        config.py:180-212): `overrides` {pattern: spec} win over the fp
        list and the default (`resolve_layer_spec`); then the first
        `backend_overrides` pattern that matches sets the layer's backend:
        'weight_only' is native with act_quant off, 'fused' native with
        impl 'fused'."""

        def resolve(name: str) -> LayerQuantSpec:
            spec = resolve_layer_spec(name, self.default_layer,
                                      self.fp_patterns, overrides)
            if (self.softmax_scope and spec.softmax is not None
                    and not any_pattern_in(name, self.softmax_scope)):
                spec = dataclasses.replace(spec, softmax=None)
            if (self.attn_act_scope and spec.attn_act is not None
                    and not any_pattern_in(name, self.attn_act_scope)):
                spec = dataclasses.replace(spec, attn_act=None)
            for pat, mode in self.backend_overrides:
                if pattern_in(name, pat):
                    if mode == "weight_only":
                        spec = dataclasses.replace(spec, backend="native",
                                                   act_quant=False)
                    elif mode == "fused":
                        spec = dataclasses.replace(spec, backend="native",
                                                   impl="fused")
                    else:
                        spec = dataclasses.replace(spec, backend=mode)
                    break
            return spec
        return resolve

    def uses_native(self) -> bool:
        """True when any layer runs the native int backend, by the default
        or by a backend override (JAX config.py:214-221): packed int slabs
        must exist before a quantized run."""
        if self.default_layer.backend == "native":
            return True
        return any(mode in ("native", "weight_only", "fused", "static")
                   for _, mode in self.backend_overrides)

    def with_bits(self, w_bits: Optional[int] = None,
                  a_bits: Optional[int] = None) -> "QuantPlanConfig":
        """The plan with other active bitwidths (reference set_layer_bit /
        bitwidth_refactor; JAX config.py:236-245): `QuantSpec.with_bits`
        of the default weight and act specs."""
        d = self.default_layer
        return dataclasses.replace(self, default_layer=dataclasses.replace(
            d,
            weight=(d.weight.with_bits(w_bits) if w_bits and d.weight
                    else d.weight),
            act=d.act.with_bits(a_bits) if a_bits and d.act else d.act))

    def with_backend(self, backend: str) -> "QuantPlanConfig":
        """The plan with another default backend
        (viditq_tpu/utils/config.py:223-234): 'simulate' (fake quant, the
        reference's semantics), 'native' (the int8 execution of the
        layer's impl) or 'fused' (native with impl 'fused', as the YAML
        `backend: fused`). Per-group `backend_overrides` still win."""
        if backend == "fused":
            return dataclasses.replace(
                self, default_layer=dataclasses.replace(
                    self.default_layer, backend="native", impl="fused"))
        return dataclasses.replace(
            self, default_layer=dataclasses.replace(
                self.default_layer, backend=backend))


def load_quant_config(path: str,
                      smooth_quant_alpha: Optional[float] = None,
                      timestep_wise: bool = False) -> QuantPlanConfig:
    """Load a reference-format quant YAML (t2v/scripts/ptq.py:60-148; JAX
    config.py:248-341). The `part_fp_list` layers stay fp.
    smooth_quant_alpha: every CB timerange's alpha (where the plan
    enables CB); timestep_wise: static act tables with one slot per
    calibration step (the YAML's `calib_data.n_steps`; the JAX CLI's
    `--timestep_wise`), otherwise one."""
    with open(path) as f:
        cfg = yaml.safe_load(f)
    mp = cfg.get("mixed_precision")
    quant = cfg["quant"]
    calib = cfg.get("calib_data", {})
    n_ts = int(calib.get("n_steps", 10))
    wspec = parse_weight_spec(quant["weight"], mp)
    aspec = parse_act_spec(quant["activation"], mp,
                           timestep_wise=timestep_wise, n_timestep=n_ts)
    smooth = parse_smooth_spec(quant["activation"])
    if smooth_quant_alpha is not None and smooth.enable:
        smooth = dataclasses.replace(
            smooth, alpha=tuple(float(smooth_quant_alpha)
                                for _ in smooth.alpha))
    # optional attention-internal quantizers ('softmax:' / 'attn_act:'
    # under the act quantizer)
    act_q_cfg = quant["activation"]["quantizer"]
    softmax_spec = attn_act_spec = None
    sm_cfg = act_q_cfg.get("softmax")
    if isinstance(sm_cfg, dict) and sm_cfg.get("n_bits"):
        softmax_spec = QuantSpec(
            n_bits=int(sm_cfg["n_bits"]),
            granularity=_granularity(sm_cfg.get("per_group", False)),
            round_mode=sm_cfg.get("round_mode", "nearest_ste"),
            always_zero=bool(sm_cfg.get("always_zero", True)),
            dynamic=True)
    aa_cfg = act_q_cfg.get("attn_act")
    if isinstance(aa_cfg, dict) and aa_cfg.get("n_bits"):
        attn_act_spec = QuantSpec(
            n_bits=int(aa_cfg["n_bits"]),
            granularity=_granularity(aa_cfg.get("per_group", "token")),
            round_mode=aa_cfg.get("round_mode", "nearest_ste"),
            sym=bool(aa_cfg.get("sym", False)),
            dynamic=True)
    default = LayerQuantSpec(weight=wspec, act=aspec, smooth_quant=smooth,
                             softmax=softmax_spec, attn_act=attn_act_spec)
    # plan-level default backend; `backend: fused` is native + the fused
    # kernel dataflow (viditq_tpu/utils/config.py:288-295)
    plan_backend = cfg.get("backend")
    if plan_backend == "fused":
        default = dataclasses.replace(default, backend="native",
                                      impl="fused")
    elif plan_backend:
        default = dataclasses.replace(default, backend=str(plan_backend))

    fp_patterns: Tuple[str, ...] = ()
    fp_path = cfg.get("part_fp_list")
    if fp_path and fp_path not in ("", "None"):
        try:
            fp_patterns = load_fp_list(fp_path)
        except FileNotFoundError:
            # allow paths relative to the YAML's directory
            alt = os.path.join(os.path.dirname(path),
                               os.path.basename(fp_path))
            fp_patterns = load_fp_list(alt)

    def scope(q_cfg):
        return tuple(q_cfg.get("scope") or ()) if isinstance(q_cfg, dict) \
            else ()
    backend_ov = tuple((str(k), str(v)) for k, v in
                       (cfg.get("backend_overrides") or {}).items())
    return QuantPlanConfig(
        default_layer=default, fp_patterns=fp_patterns,
        backend_overrides=backend_ov,
        cfg_split=bool(cfg.get("cfg_split", False)),
        mixed_precision=tuple(mp) if mp else None,
        timestep_wise=timestep_wise,
        calib_n_steps=n_ts,
        calib_batch_size=int(calib.get("batch_size", 4)),
        softmax_scope=scope(sm_cfg), attn_act_scope=scope(aa_cfg),
        weight_opt=parse_optimization(quant["weight"].get("optimization")),
        act_opt=parse_optimization(
            quant["activation"].get("optimization")),
        resume_w_path=_resume_w_path(cfg.get("resume_with_w_quantized")))


def load_bitwidth_config(path: str) -> Dict[str, Any]:
    """A timestep-wise mixed-precision YAML: {'19-15': {layer: bits, ...},
    ..., 'fp_layers': [...]} (reference t20_*_mp.yaml,
    gaussian_diffusion.py:740-767; JAX config.py:349-354)."""
    with open(path) as f:
        return yaml.safe_load(f)
