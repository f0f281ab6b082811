"""Checkpoint conversion and files (port of `viditq_tpu/utils/ckpt.py`).

* A reference `.pth` state dict (OpenSora STDiT, PixArt) becomes the
  port's state dict in one step: the fused self-attention `qkv` is split
  into q/k/v (`t2v/scripts/split_ckpt.py:3-25`), module paths are renamed
  as the JAX package renames them (ckpt.py:66-107), and each tensor takes
  the port's layout: a Linear `weight` [out, in] becomes `kernel` [in,
  out], an affine norm's `weight` becomes `scale`, the patchify conv
  [D, C_in, *k] becomes the port's patch matrix [prod(k) * C_in, D]
  (`utils/bridge.py`), the depthwise KV-compress conv `sr` [C, 1, r, r]
  becomes [r, r, 1, C], the layout the port (and the JAX package) keep.
  The sincos `pos_embed*` tables are recomputed, so they are skipped;
  `y_embedder.y_embedding` is kept as the file holds it.
  `reference_state_dict` is the inverse.
* `save_params`/`load_params`: the port's parameters as a `torch.save`
  file, read back with `weights_only=True`. The JAX package's msgpack is
  not read (its reader is flax).
* `save_train_state`/`load_train_state`: a resumable training checkpoint,
  the parameters, their EMA and the optimizer state (its step count is
  the learning-rate schedule's) in one `torch.save` file, read back with
  `weights_only=True`, and beside it the JAX package's
  `<path>.meta.json` of counters (epoch, step, global_step, the data
  sampler's state; ckpt.py:192-224). The JAX package's msgpack and orbax
  train states are not read (flax and orbax formats).
* `save_quant_ckpt`/`load_quant_ckpt`: the JAX package's quant checkpoint
  format exactly (ckpt.py:286-310), so a file crosses between the
  packages: an npz of `"<dotted layer>::<table>"` arrays (the layer names
  of `viditq_tpu/quant/calibrate.py:30-45`) and `__meta__`, a pickled dict
  (`act_slot_map`, `calib_ts`, `ptq_config`) as uint8. The port writes the
  tables the JAX `ptq` writes, with their names and shapes, and the
  `cbshare__<child>` copies of a child's `cb_scale` that a JAX parent
  keeps (`cbshare_leaves`); it writes none of the packed buffers (`w_int`,
  `w_colsum`): they are packed again after a load. Reading a JAX file,
  each `cbshare__*` leaf is held equal to its child's `cb_scale` and
  dropped, and the packed buffers are skipped. `__meta__` is read with an
  unpickler that admits numpy and builtins only.
"""

from __future__ import annotations

import io
import json
import os
import pickle
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from viditq_tpu_torch.models.layers import CrossAttention, Mlp, SelfAttention
from viditq_tpu_torch.models.pixart import PixArtBlock
from viditq_tpu_torch.models.stdit import STDiTBlock
from viditq_tpu_torch.quant.qlinear import QuantLinear, is_fused_dynamic

# ---------------- reference .pth -> the port's state dict ----------------


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's tensors as float32 on the CPU: the raw
    state dict, or the one under 'state_dict', or its 'ema' (ckpt.py:
    38-45)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if "ema" in sd and isinstance(sd["ema"], dict):
        sd = sd["ema"]
    return {k: v.detach().float() for k, v in sd.items()}


def split_qkv(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fused `*.qkv.{weight,bias}` -> q/k/v (split_ckpt.py:3-25: the weight
    viewed [3, D, D] and unbound)."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".qkv.weight"):
            d = v.shape[-1]
            for name, w in zip("qkv", v.reshape(3, d, d)):
                out[k.replace(".qkv.weight", f".{name}.weight")] = w
        elif k.endswith(".qkv.bias"):
            d = v.shape[-1] // 3
            for name, b in zip("qkv", v.reshape(3, d)):
                out[k.replace(".qkv.bias", f".{name}.bias")] = b
        else:
            out[k] = v
    return out


# reference module-path prefix -> the port's (ckpt.py:66-76)
RENAMES = {
    "t_embedder.mlp.0": "t_embedder.fc1",
    "t_embedder.mlp.2": "t_embedder.fc2",
    "t_block.1": "t_block.linear",
    "y_embedder.y_proj.fc1": "y_embedder.fc1",
    "y_embedder.y_proj.fc2": "y_embedder.fc2",
    "csize_embedder.mlp.0": "csize_embedder.fc1",
    "csize_embedder.mlp.2": "csize_embedder.fc2",
    "ar_embedder.mlp.0": "ar_embedder.fc1",
    "ar_embedder.mlp.2": "ar_embedder.fc2",
}
# recomputed constants (the sincos position tables, dit.py:122-123)
SKIP_KEYS = ("pos_embed", "pos_embed_temporal", "pos_embed_spatial")
PATCH_CONV = "x_embedder.proj"
NORM_SEGMENTS = ("q_norm", "k_norm", "norm")


def port_name(key: str) -> Optional[str]:
    """A reference tensor's name in the port's state dict (ckpt.py:82-107),
    None for a skipped one. The leaf `weight` of a linear or conv becomes
    `kernel`, of an affine norm `scale`."""
    for pre, post in RENAMES.items():
        if key.startswith(pre + "."):
            key = post + key[len(pre):]
    parts = key.split(".")
    if parts[0] in SKIP_KEYS:
        return None
    if "adaLN_modulation" in parts:  # Sequential(SiLU, Linear)
        i = parts.index("adaLN_modulation")
        parts = parts[:i] + ["adaLN_linear"] + parts[i + 2:]
    if parts[-2:] == ["embedding_table", "weight"]:
        return ".".join(parts[:-2] + ["embedding"])
    if parts[-1] == "weight":
        is_norm = any(p in parts for p in NORM_SEGMENTS)
        parts[-1] = "scale" if is_norm else "kernel"
    return ".".join(parts)


def _is_conv(key: str, val: torch.Tensor) -> bool:
    base = key.rsplit(".", 1)[0]
    return val.ndim >= 3 and (PATCH_CONV in base or ".sr" in base)


def convert_dit_checkpoint(path_or_sd) -> Dict[str, torch.Tensor]:
    """A reference DiT-family checkpoint (a `.pth` path or its state
    dict; STDiT and PixArt alike) -> the port's state dict (module
    header)."""
    sd = (load_torch_state_dict(path_or_sd)
          if isinstance(path_or_sd, (str, os.PathLike)) else path_or_sd)
    out: Dict[str, torch.Tensor] = {}
    for key, val in split_qkv(sd).items():
        name = port_name(key)
        if name is None:
            continue
        val = val.float()
        if name.endswith(".kernel"):
            if _is_conv(key, val):
                # [O, I, *k] -> [*k, I, O]; the patch conv then flattens
                # to the port's patch matrix [prod(k) * I, O]
                val = val.permute(*range(2, val.ndim), 1, 0)
                if PATCH_CONV in key:
                    val = val.reshape(-1, val.shape[-1])
            elif val.ndim == 2:
                val = val.t()
        out[name] = val.contiguous()
    return out


def reference_state_dict(sd: Mapping[str, torch.Tensor],
                         patch: Sequence[int]) -> Dict[str, torch.Tensor]:
    """The inverse of `convert_dit_checkpoint`: a port state dict (its
    parameters) in the reference's names and layouts, with q/k/v fused
    into `qkv` wherever the three sit side by side. patch: the patchify
    conv's kernel size ((pt, ph, pw) or (p, p))."""
    inv = {post: pre for pre, post in RENAMES.items()}
    out: Dict[str, torch.Tensor] = {}
    for name, val in sd.items():
        parts = name.split(".")
        leaf = parts[-1]
        val = val.detach().float().cpu()
        if leaf == "kernel":
            if name == PATCH_CONV + ".kernel":
                c_in = val.shape[0] // int(np.prod(patch))
                val = val.reshape(*patch, c_in, val.shape[-1])
            if val.ndim >= 3:  # [*k, I, O] -> [O, I, *k]
                val = val.permute(val.ndim - 1, val.ndim - 2,
                                  *range(val.ndim - 2))
            elif val.ndim == 2:
                val = val.t()
            parts[-1] = "weight"
        elif leaf == "scale":
            parts[-1] = "weight"
        elif leaf == "embedding":
            parts[-1:] = ["embedding_table", "weight"]
        if "adaLN_linear" in parts:
            i = parts.index("adaLN_linear")
            parts[i:i + 1] = ["adaLN_modulation", "1"]
        key = ".".join(parts)
        for post, pre in inv.items():
            if key.startswith(post + "."):
                key = pre + key[len(post):]
        out[key] = val.contiguous()
    # fuse q/k/v siblings (the split's inverse: weights stacked on dim 0)
    for key in [k for k in out if k.endswith(".q.weight")]:
        base = key[:-len(".q.weight")]
        names = [f"{base}.{n}" for n in "qkv"]
        if not all(f"{n}.weight" in out for n in names):
            continue
        for leaf in ("weight", "bias"):
            if all(f"{n}.{leaf}" in out for n in names):
                out[f"{base}.qkv.{leaf}"] = torch.cat(
                    [out.pop(f"{n}.{leaf}") for n in names])
    return out


def patch_of(model: nn.Module) -> Tuple[int, ...]:
    """The patchify conv's kernel size of a port model."""
    p = model.x_embedder.patch_size
    return tuple(p) if isinstance(p, (tuple, list)) else (p, p)


# ---------------- the port's parameters ----------------

def save_params(path: str, sd: Mapping[str, torch.Tensor]) -> None:
    torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
               path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_params_into(model: nn.Module, path_or_sd,
                     extra_ok: bool = False) -> nn.Module:
    """Copy a `save_params` file (or a state dict of parameters) into the
    model's parameters: every parameter must be in it and, unless
    extra_ok (e.g. a whole VAE's file into its encoder), nothing else (the
    quant tables are not parameters)."""
    is_path = isinstance(path_or_sd, (str, os.PathLike))
    sd = load_params(path_or_sd) if is_path else path_or_sd
    want = {n for n, _ in model.named_parameters()}
    missing, extra = want - set(sd), set(sd) - want
    if extra_ok:
        sd, extra = {k: v for k, v in sd.items() if k in want}, set()
    if missing or extra:
        raise KeyError(f"{path_or_sd if is_path else 'parameters'}: "
                       f"missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
    res = model.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    return model


def save_train_state(path: str, params: Mapping[str, torch.Tensor],
                     ema: Mapping[str, torch.Tensor], opt_state,
                     meta: Optional[Dict] = None) -> None:
    """One training checkpoint (the reference booster's save, train.py:
    243-257): {'params', 'ema', 'opt_state'} by `torch.save`, the counters
    in `<path>.meta.json`."""
    torch.save({"params": {k: v.detach() for k, v in params.items()},
                "ema": dict(ema), "opt_state": opt_state}, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta or {}, f)


def load_train_state(path: str, device=None) -> tuple:
    """(params, ema, opt_state, meta) of a `save_train_state` file, its
    tensors on device; meta {} without a sidecar."""
    state = torch.load(path, map_location=device, weights_only=True)
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return state["params"], state["ema"], state["opt_state"], meta


# ---------------- quant checkpoints (the JAX package's format) ----------

# the tables of a layer that a PTQ run writes (qlinear.py:352-478; the
# static act ranges a_min/a_max/a_init are calibration state, not saved;
# w_alpha: AdaRound's rounding logits)
QUANT_TABLES = ("w_delta", "w_zp", "w_alpha", "act_scale", "cb_scale",
                "a_delta", "a_zp")
# packed from the tables after a load; a JAX file may hold them
PACKED = ("w_int", "w_colsum", "w_mp_scale", "w_mp_zp")
CBSHARE = "cbshare__"


def _cbshare_spec(lspec) -> bool:
    """Where a JAX parent declares a child's `cbshare__` copy
    (`cbshare_inv_cs`, qlinear.py:113-145): momentum CB on the native
    dynamic-act path."""
    return (lspec is not None and lspec.smooth_quant.enable
            and "momentum" in lspec.smooth_quant.channel_wise_scale_type
            and lspec.backend == "native" and lspec.act is not None
            and lspec.act.dynamic and lspec.act_quant and lspec.weight_quant)


def _specs(mod: nn.Module, names: Sequence[str]):
    """The specs of mod's QuantLinear children at dotted names."""
    return [mod.get_submodule(n).lspec for n in names]


def cbshare_leaves(model: nn.Module) -> Dict[Tuple[str, str], str]:
    """{(parent dotted name, 'cbshare__<child>'): child dotted name} for
    every copy of a child's `cb_scale` the JAX model of the same plan
    holds: the block's LN+modulate+quantize producer over attn q/k/v (not
    a KV-compressed attention) and over mlp.fc1 (layers.py:311-342), the
    MLP's GELU handoff to fc2 (layers.py:97-112), the self-attention's
    shared q/k/v quantize (layers.py:437-448) and the attention emission
    into proj (layers.py:480-488, 700-709)."""
    out: Dict[Tuple[str, str], str] = {}

    def add(parent: str, child: str):
        full = f"{parent}.{child}" if parent else child
        out[(parent, CBSHARE + child.replace(".", "__"))] = full

    for pname, mod in model.named_modules():
        if isinstance(mod, (STDiTBlock, PixArtBlock)):
            groups = [("mlp.fc1",)]
            if not getattr(mod, "kv_compress", False):
                groups.insert(0, ("attn.q", "attn.k", "attn.v"))
            for names in groups:
                specs = _specs(mod, names)
                s0 = specs[0]
                if (all(s == s0 for s in specs) and is_fused_dynamic(s0)
                        and _cbshare_spec(s0)
                        and (len(names) == 1
                             or s0.smooth_quant.qkv_share_cs)):
                    add(pname, names[0])
        elif isinstance(mod, Mlp):
            s2 = mod.fc2.lspec
            if is_fused_dynamic(s2) and _cbshare_spec(s2):
                add(pname, "fc2")
        elif isinstance(mod, (SelfAttention, CrossAttention)):
            if isinstance(mod, SelfAttention):
                specs = _specs(mod, ("q", "k", "v"))
                if (all(s == specs[0] for s in specs)
                        and _cbshare_spec(specs[0])
                        and specs[0].smooth_quant.qkv_share_cs):
                    add(pname, "q")
            if _cbshare_spec(mod.proj.lspec):
                add(pname, "proj")
    return out


def quant_tables(model: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    """{dotted layer: {table: array}} of every quantizer table the JAX
    'quant' collection holds for this plan (calibrate.py:316-324)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, QuantLinear):
            continue
        for tab in QUANT_TABLES:
            buf = getattr(mod, tab, None)
            if isinstance(buf, torch.Tensor):
                out.setdefault(name, {})[tab] = (
                    buf.detach().float().cpu().numpy())
    for (parent, leaf), child in cbshare_leaves(model).items():
        out.setdefault(parent, {})[leaf] = out[child]["cb_scale"]
    return out


def save_quant_ckpt(path: str, model: nn.Module,
                    meta: Optional[Dict] = None) -> None:
    """The model's quant tables and `meta` in the JAX package's npz
    format (ckpt.py:286-295)."""
    flat = {f"{name}::{k}": v for name, tabs in quant_tables(model).items()
            for k, v in tabs.items()}
    if meta:
        flat["__meta__"] = np.frombuffer(pickle.dumps(meta), np.uint8)
    np.savez(path, **flat)


class _MetaUnpickler(pickle.Unpickler):
    """Admits numpy's array and scalar reconstruction and plain builtins:
    a `__meta__` that names any other class (a JAX array, a module to
    import) is refused."""

    SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int",
                     "float", "str", "bytes", "bool", "complex", "slice",
                     "range", "NoneType", "bytearray"}

    def find_class(self, module, name):
        if module == "builtins" and name in self.SAFE_BUILTINS:
            return super().find_class(module, name)
        if module in ("numpy", "numpy.core.multiarray",
                      "numpy._core.multiarray", "numpy.core.numeric",
                      "numpy._core.numeric") and name in (
                          "ndarray", "dtype", "_reconstruct", "scalar",
                          "_frombuffer"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"quant checkpoint meta names {module}.{name}, which is not "
            "numpy or a builtin")


def load_meta(raw: np.ndarray) -> Dict:
    return _MetaUnpickler(io.BytesIO(raw.tobytes())).load()


def read_quant_ckpt(path: str) -> Tuple[Dict[str, Dict[str, np.ndarray]],
                                        Optional[Dict]]:
    """({dotted layer: {table: array}}, meta) of a quant checkpoint, with
    the `cbshare__*` copies checked against their children and dropped
    (`utils/bridge.py`) and the packed buffers left out."""
    data = np.load(path, allow_pickle=False)
    tables: Dict[str, Dict[str, np.ndarray]] = {}
    meta = None
    for key in data.files:
        if key == "__meta__":
            meta = load_meta(data[key])
            continue
        name, tab = key.split("::")
        tables.setdefault(name, {})[tab] = data[key]
    for name, tabs in tables.items():
        for tab in [t for t in tabs if t.startswith(CBSHARE)]:
            child = ".".join(filter(None, (
                name, tab[len(CBSHARE):].replace("__", "."))))
            src = tables.get(child, {}).get("cb_scale")
            if src is None or not np.array_equal(src, tabs[tab]):
                raise ValueError(
                    f"{path}: {name}::{tab} is not a copy of "
                    f"{child}::cb_scale" + (" (absent)" if src is None
                                            else ""))
            del tabs[tab]
        for tab in PACKED:
            tabs.pop(tab, None)
    return {k: v for k, v in tables.items() if v}, meta


def load_quant_ckpt(path: str, model: nn.Module) -> Optional[Dict]:
    """Load a quant checkpoint (either package's) into the model's
    QuantLinear tables; returns its meta. A layer the model lacks raises
    KeyError, a table of another shape ValueError (ckpt.py:298-310,
    calibrate.py:327-342); a static act table takes the shape it was
    calibrated at. Pack the native slabs after it."""
    tables, meta = read_quant_ckpt(path)
    mods = dict(model.named_modules())
    sd = {}
    for name, tabs in tables.items():
        mod = mods.get(name)
        if not isinstance(mod, QuantLinear):
            raise KeyError(f"quant ckpt layer {name} not present in model")
        for tab, arr in tabs.items():
            cur = getattr(mod, tab, None)
            if not isinstance(cur, torch.Tensor):
                raise KeyError(f"quant ckpt table {name}::{tab} is not a "
                               "table of the model's layer under this plan")
            static = mod.static_act and tab in ("a_delta", "a_zp")
            if not static and tuple(cur.shape) != tuple(arr.shape):
                raise ValueError(f"{name}.{tab}: ckpt shape {arr.shape} "
                                 f"!= model {tuple(cur.shape)}")
            sd[f"{name}.{tab}"] = torch.from_numpy(np.array(arr))
    res = model.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys, res.unexpected_keys
    return meta
