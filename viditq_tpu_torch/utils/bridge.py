"""Bridge from the JAX package's variable trees to the port's state dict.

`state_dict_from_flax(params, quant, qstats)` takes the `params`, `quant`
and (optionally) `qstats` collections of a `viditq_tpu` model as nested
dicts of numpy arrays and returns the tensors the port's model of the
same configuration loads with `load_state_dict(..., strict=True)`:

  * module paths become the port's dotted names: a list container named
    `blocks_3` becomes `blocks.3` (calibrate.py:30-45's rule);
  * the scanned layouts (`scan_blocks=True`) are split into `blocks.{i}`:
    one `blocks` container (stdit.py:267-286), or PixArt-Σ's runs of
    uniform blocks, one container per run named by its first block,
    `blocks_0` and `blocks_14` (pixart.py:203-242). A container is scanned
    when its `scale_shift_table` has a leading depth axis (3 dims; a
    block's own table is [6, C]); run `blocks_{s}` holds blocks s, s+1, ...;
  * flax Dense kernels stay [K, N] (the port keeps that layout), so the
    fp heads of DiT, Latte and MMDiT come across by name: each block's
    `adaLN_linear`, `final_layer.adaLN_linear`, MMDiT's
    `context_embedder`, `y_embedder_fc1`, `y_embedder`, `final_adaLN`
    and `final_linear`, and the label table `y_embedder.embedding`;
    MMDiT's per-stream modules keep their flax names (`img_attn.q`,
    `img_attn_proj`, `txt_mlp.fc1`), which the port's modules take too
    (their plan names, `blocks.N.img_attn.proj`, only pick the spec);
  * a patchify conv kernel (`x_embedder.proj`, [pt, ph, pw, C_in, D] or
    [ph, pw, C_in, D]: STDiT, DiT and Latte's 3D, PixArt and MMDiT's 2D)
    becomes the port's patch matrix [pt*ph*pw*C_in, D]
    (the same flatten order); the depthwise KV-compress conv kernel
    (`attn.sr.kernel`, [r, r, 1, C]) keeps its layout, which
    `DepthwiseQuantConv` uses as it is;
  * the packed quant leaves (`w_delta`, `w_zp`, `w_int`, `w_colsum`), the
    channel-balancing tables (`act_scale`, `cb_scale`) and the per-range
    dequant tables of timestep-wise mixed precision (`w_mp_scale`,
    `w_mp_zp`, the JAX package's union variables) become buffers of the
    same names and shapes (one slab per timerange; a weight-only layer's
    nibble-packed W4 slab [n_tr, (K+1)//2, N] too);
  * the static act tables (`a_delta`, `a_zp`, [n_bw, n_ts, 1, *group])
    and, from `qstats`, their calibration state (`a_min`, `a_max`,
    `a_init`); the other `qstats` leaves (the CB statistic's `sq_init`)
    are the port's unsaved state and are left out;
  * a `cbshare__<child>` leaf, the copy of a child layer's `cb_scale` that
    a flax parent keeps because it cannot read its children's variables
    (qlinear.py:113-145), must equal that child's table (else ValueError)
    and is dropped: the port's parents read the child's table.

`vae_state_dict_from_flax(params)` does the same for the VAE's `params`
(`viditq_tpu/models/vae.py`; `models/vae.py` keeps its module names):
flax conv kernels [kh, kw, in, out] become [out, in, kh, kw], the
temporal (3, 1, 1) convs' [3, 1, 1, in, out] become [out, in, 3, 1, 1],
Dense kernels are transposed, each GroupNorm's `gn.scale`/`gn.bias`
become `weight`/`bias`, `mix_factor` stays as it is. It does not go
through the backbone's `_convert`, which flattens every kernel above two
dims for the patchify convs.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _dotted(path: tuple) -> str:
    segs = []
    for p in path:
        base, sep, tail = p.rpartition("_")
        if sep and tail.isdigit():
            segs.extend([base, tail])
        else:
            segs.append(p)
    return ".".join(segs)


def _convert(name: str, arr: np.ndarray) -> tuple:
    if (name.endswith(".kernel") and arr.ndim > 2
            and not name.endswith(".sr.kernel")):
        arr = arr.reshape(-1, arr.shape[-1])
    return name, torch.from_numpy(np.array(arr, copy=True))


def scanned_runs(params: Mapping) -> Dict[str, int]:
    """Scanned block containers of a params tree -> their first block."""
    runs = {}
    for key, sub in params.items():
        base, sep, tail = key.rpartition("_")
        if key == "blocks":
            start = 0
        elif base == "blocks" and sep and tail.isdigit():
            start = int(tail)
        else:
            continue
        if np.ndim(sub.get("scale_shift_table")) == 3:
            runs[key] = start
    return runs


CBSHARE = "cbshare__"


def drop_cbshare(flat: Dict[tuple, np.ndarray]) -> Dict[tuple, np.ndarray]:
    """The flattened quant tree without its `cbshare__*` leaves, each first
    held equal to the `cb_scale` of the child it names (its path below the
    leaf's module, `__` for `.`; qlinear.py:113-145)."""
    out = {}
    for path, arr in flat.items():
        if not path[-1].startswith(CBSHARE):
            out[path] = arr
            continue
        child = (path[:-1] + tuple(path[-1][len(CBSHARE):].split("__"))
                 + ("cb_scale",))
        src = flat.get(child)
        if src is None or not np.array_equal(src, arr):
            raise ValueError(
                f"{'.'.join(path)}: not a copy of {'.'.join(child)}"
                + (" (absent)" if src is None else ""))
    return out


# the `qstats` leaves the port saves: the static act ranges
ACT_STATS = ("a_min", "a_max", "a_init")


def state_dict_from_flax(params: Mapping,
                         quant: Optional[Mapping] = None,
                         qstats: Optional[Mapping] = None
                         ) -> Dict[str, torch.Tensor]:
    runs = scanned_runs(params)
    out: Dict[str, torch.Tensor] = {}
    stats = {k: v for k, v in _flatten(qstats or {}).items()
             if k[-1] in ACT_STATS}
    for flat in (_flatten(params), drop_cbshare(_flatten(quant or {})),
                 stats):
        for path, arr in flat.items():
            if path[0] in runs:
                # scanned run: leading depth axis on every leaf
                for d in range(arr.shape[0]):
                    name = _dotted(("blocks", str(runs[path[0]] + d))
                                   + path[1:])
                    k, v = _convert(name, arr[d])
                    out[k] = v
                continue
            k, v = _convert(_dotted(path), arr)
            out[k] = v
    return out


def vae_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX VAE's params tree (AutoencoderKL, VideoAutoencoderKL,
    VideoAutoencoderKLTemporalDecoder, or any of their Encoder / Decoder /
    TemporalDecoder) -> the state dict of the port's module of the same
    configuration (module docstring)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params).items():
        *mods, leaf = path
        if mods and mods[-1] == "gn":  # GroupNorm's inner flax module
            mods = mods[:-1]
            leaf = {"scale": "weight", "bias": "bias"}[leaf]
        elif leaf == "kernel":
            leaf = "weight"
            # flax [*spatial, in, out] -> torch [out, in, *spatial]
            arr = np.moveaxis(arr, (-1, -2), (0, 1))
        out[".".join((*mods, leaf))] = torch.from_numpy(
            np.array(arr, dtype=np.float32, copy=True))
    return out
