"""Bridge from the JAX package's variable trees to the port's state dict.

`state_dict_from_flax(params, quant)` takes the `params` and `quant`
collections of a `viditq_tpu` model as nested dicts of numpy arrays and
returns the tensors the port's model of the same configuration loads with
`load_state_dict(..., strict=True)`:

  * module paths become the port's dotted names: a list container named
    `blocks_3` becomes `blocks.3` (calibrate.py:30-45's rule);
  * the scanned layout (`scan_blocks=True`: one `blocks` container whose
    every leaf has a leading depth axis, stdit.py:267-286) is split into
    `blocks.{d}`;
  * flax Dense kernels stay [K, N] (the port keeps that layout);
  * a conv kernel (`x_embedder.proj`, [pt, ph, pw, C_in, D]) becomes the
    port's 2D patch matrix [pt*ph*pw*C_in, D] (the same flatten order);
  * the packed quant leaves (`w_delta`, `w_zp`, `w_int`, `w_colsum`)
    become buffers of the same names and shapes.
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
    if name.endswith(".kernel") and arr.ndim > 2:
        arr = arr.reshape(-1, arr.shape[-1])
    return name, torch.from_numpy(np.array(arr, copy=True))


def state_dict_from_flax(params: Mapping,
                         quant: Optional[Mapping] = None
                         ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, quant or {}):
        for path, arr in _flatten(tree).items():
            if path[0] == "blocks":
                # scanned stack: leading depth axis on every leaf
                for d in range(arr.shape[0]):
                    name = _dotted(("blocks", str(d)) + path[1:])
                    k, v = _convert(name, arr[d])
                    out[k] = v
                continue
            k, v = _convert(_dotted(path), arr)
            out[k] = v
    return out
