"""Analysis helpers (the timestep-wise mixed-precision part of
`viditq_tpu/pipelines/analysis.py:452-489`).

A bitwidth-config YAML (reference `t20_weight_4_mp.yaml`) maps sampler-step
ranges ('19-15', in the sampler's step indices, high to low) to per-layer
bits under the reference's `model.` naming. These functions turn it into
ranges in sampling order and into per-layer spec overrides; the
sensitivity, sweep and PTQD tools of the JAX module are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from viditq_tpu_torch.quant.spec import LayerQuantSpec


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
