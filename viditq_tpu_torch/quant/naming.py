"""Layer-name pattern matching and per-layer quant layout resolution.

The port's copy of `viditq_tpu/quant/naming.py`: the reference's glob-ish
`pattern_in` matcher (`qdiff/models/quant_model.py:14-36`), so ViDiT-Q
layer lists (`remain_fp.txt`, bitwidth-config YAMLs like
`blocks.[0-13].attn.q`) match the port's dotted module names
(`blocks.0.attn.q`, identical to the JAX package's resolver names).
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence

from viditq_tpu_torch.quant.spec import LayerQuantSpec


def _segment_match(seg: str, pat: str) -> bool:
    if pat == "*":
        return True
    if pat.startswith("[") and pat.endswith("]") and "-" in pat:
        lo, hi = pat[1:-1].split("-")
        try:
            return int(lo) <= int(seg) <= int(hi)
        except ValueError:
            return False
    return seg == pat


def pattern_in(text: str, pattern: str) -> bool:
    """True if `pattern` (dot-segmented, '*' wildcard, '[a-b]' int ranges)
    matches a contiguous run of segments anywhere inside dotted `text`.

    Reference: quant_model.py:14-36. A bare substring like "attn" also
    matches segment "attn" anywhere (used by `remain_fp.txt` entries such as
    "final_layer" and group names such as "cross_attn").
    """
    pats = pattern.split(".")
    segs = text.split(".")
    for i in range(len(segs) - len(pats) + 1):
        if all(_segment_match(segs[i + j], pats[j]) for j in range(len(pats))):
            return True
    return False


def any_pattern_in(text: str, patterns: Iterable[str]) -> bool:
    return any(pattern_in(text, p) for p in patterns if p)


def resolve_layer_spec(name: str, default: LayerQuantSpec,
                       fp_patterns: Sequence[str] = (),
                       overrides: Optional[Mapping[str, LayerQuantSpec]]
                       = None) -> LayerQuantSpec:
    """Resolve the effective LayerQuantSpec for a dotted layer name. Order
    (JAX naming.py:48-65): an override whose pattern matches (the first in
    the mapping's order; `pattern_in` semantics, so a module prefix such
    as `blocks.0.attn` covers `blocks.0.attn.q`) > the fp list, which
    disables quantization (reference `--part_fp` + remain_fp.txt,
    t2v/scripts/ptq.py:199-205) > the default."""
    if overrides:
        for pat, spec in overrides.items():
            if pattern_in(name, pat):
                return spec
    if any_pattern_in(name, fp_patterns):
        return default.disabled()
    return default


def load_fp_list(path: str) -> tuple:
    """Read a remain_fp.txt-style file (one pattern per line)."""
    with open(path) as f:
        return tuple(ln.strip() for ln in f if ln.strip())
