"""The PTQ flow: smooth-quant statistics -> weight tables -> static act
tables (port of `viditq_tpu/pipelines/ptq.py:22-181`).

Reference flow: `t2v/scripts/ptq.py:27-451` / `t2i/scripts/ptq.py:40-517`.
The port's model holds its tables as buffers, so each phase runs the
model's forwards in a calibration mode and fills them in place:

  1. 'sq_stat' forwards over the subsampled calibration steps, where a
     layer runs a momentum channel-balancing type (`act_scale`);
  2. `calibrate_weight_tables` (cb_scale, then w_delta/w_zp);
  3. where a layer quantizes its acts statically, 'a_calib' forwards over
     the same steps, each with its step's act-table slot, then
     `finalize_act_tables` (a_delta/a_zp).

Packing the native slabs (`quant.native_pack.pack_native_weights`)
follows, as in the JAX flow. With `resume_w_quantized` (the plan's
`resume_with_w_quantized`, or the CLI flag) phase 2 takes the weight
tables of a saved quant checkpoint instead (JAX ptq.py:184-218). The
reconstruction pass after the act tables (AdaRound,
`quant/reconstruction.py`), where the plan asks for it, is the CLI's
`ptq` command's next step (`cli.cmd_ptq`), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from viditq_tpu_torch.quant.calibrate import (calibrate_weight_tables,
                                              finalize_act_tables)
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear


def subsample_calib_steps(n_total: int, n_steps: int) -> np.ndarray:
    """Evenly subsampled trajectory step indices (reference
    get_quant_calib_data, qdiff/utils.py:17-63: stride n_total //
    n_steps)."""
    stride = max(n_total // n_steps, 1)
    return np.arange(0, n_total, stride)[:n_steps]


def act_slot_map_from_ts(calib_ts) -> Tuple[np.ndarray, np.ndarray]:
    """(slot map [1000], sorted calibrated timesteps): slot i belongs to
    the i-th smallest calibrated timestep, and every timestep in [0, 1000)
    maps to the nearest (the first of two at equal distance): the compact
    form of `repeat_timestep_wise_quant_params` (quant_model.py:184-197)."""
    sorted_ts = np.sort(np.unique(np.asarray(calib_ts)))
    t = np.arange(1000)
    slot = np.abs(t[:, None] - sorted_ts[None, :]).argmin(axis=1)
    return slot.astype(np.int32), sorted_ts


@dataclasses.dataclass
class PTQResult:
    model: nn.Module
    act_slot_map: Optional[np.ndarray]
    calib_ts: np.ndarray


def _mask_slice(mask, b0: int, bs: int, nb: int):
    """The per-prompt mask [B0, L] rows of calib rows [b0, b0 + bs) of the
    CFG-doubled [cond; null] batch (JAX ptq.py:219-231)."""
    if mask is None:
        return None
    half = max(nb // 2, 1)
    rows = np.arange(b0, min(b0 + bs, nb)) % half
    rows = rows % mask.shape[0]
    return mask[torch.as_tensor(rows, device=mask.device)]


# the weight quantizer's tables a resumed PTQ run takes from the file
RESUMED_TABLES = ("w_delta", "w_zp", "w_alpha")


@torch.no_grad()
def resume_w_quantized(model: nn.Module, path: str) -> int:
    """Overwrite the model's weight tables (w_delta, w_zp and AdaRound's
    w_alpha) with those of a saved quant checkpoint (either package's); the
    act-side tables keep this run's values (`_merge_resumed_weight_tables`,
    JAX ptq.py:184-218). Raises ValueError for a layer the model/plan
    lacks, a table of another shape, or a file without weight tables.
    Returns the tables loaded."""
    from viditq_tpu_torch.utils.ckpt import read_quant_ckpt
    tables, _ = read_quant_ckpt(path)
    mods = dict(model.named_modules())
    n = 0
    for name, tabs in tables.items():
        for tab, arr in tabs.items():
            if tab not in RESUMED_TABLES:
                continue  # act-side tables come from this run
            cur = getattr(mods.get(name), tab, None)
            if not isinstance(cur, torch.Tensor):
                raise ValueError(
                    f"resume_with_w_quantized: checkpoint layer {name} not "
                    "in this model/plan — plan mismatch")
            if tuple(cur.shape) != tuple(arr.shape):
                raise ValueError(
                    f"resume_with_w_quantized: {name}.{tab} shape "
                    f"{arr.shape} != model's {tuple(cur.shape)} (different "
                    "bit list / timerange count?)")
            cur.copy_(torch.from_numpy(np.array(arr)))
            n += 1
    if n == 0:
        raise ValueError(f"resume_with_w_quantized: {path} holds no weight "
                         "tables")
    return n


@torch.no_grad()
def run_ptq(model: nn.Module, calib_data: Dict, plan,
            resume_w_quantized_path: Optional[str] = None) -> PTQResult:
    """Calibrate `model` in place. calib_data: {'xs': [n_steps, NB, ...],
    'ts': [n_steps, NB], 'y': [NB, 1, L, C_cap], 'mask': [B0, L] or None}
    (`pipelines.inference.get_calib_data`); `plan` gives the step count
    and batch (`calib_n_steps`, `calib_batch_size`).
    resume_w_quantized_path: a quant checkpoint whose weight tables phase
    2 takes instead of calibrating them (default the plan's
    `resume_w_path`; as in JAX, the balancing scale `cb_scale` is then
    left as it is). Returns the slot map the quantized sampler takes
    (`quant_sample(..., act_slot_map=...)`; None without static acts) and
    the calibrated timesteps."""
    xs, ts, y = calib_data["xs"], calib_data["ts"], calib_data["y"]
    mask = calib_data.get("mask")
    n_total, nb = xs.shape[0], xs.shape[1]
    n_steps = min(plan.calib_n_steps, n_total)
    bs = plan.calib_batch_size
    step_idx = subsample_calib_steps(n_total, n_steps)
    layers = [m for m in model.modules() if isinstance(m, QuantLinear)]

    def forwards(mode, slot_of=lambda t: 0):
        for s in step_idx:
            t_id = int(ts[s, 0])
            qctx = QuantCtx(t_id=t_id, mode=mode, act_slot=slot_of(t_id))
            for b0 in range(0, nb, bs):
                model(xs[s, b0:b0 + bs], ts[s, b0:b0 + bs].float(),
                      y[b0:b0 + bs], _mask_slice(mask, b0, bs, nb),
                      qctx=qctx)

    # phase 1: the momentum CB act statistics (ptq.py:219-264)
    if any(m.momentum_cb for m in layers):
        forwards("sq_stat")
    # phase 2: the weight tables, offline (ptq.py:266-293), or resumed
    resume = resume_w_quantized_path or getattr(plan, "resume_w_path", None)
    if resume:
        resume_w_quantized(model, resume)
    else:
        calibrate_weight_tables(model)
    # phase 3: static act ranges per timestep slot (ptq.py:296-361)
    calib_ts = np.array([int(ts[s, 0]) for s in step_idx])
    slot_map = None
    if any(m.static_act for m in layers):
        slot_map, sorted_ts = act_slot_map_from_ts(calib_ts)
        t_to_slot = {int(t): i for i, t in enumerate(sorted_ts)}
        forwards("a_calib", t_to_slot.__getitem__)
        finalize_act_tables(model)
    return PTQResult(model=model, act_slot_map=slot_map, calib_ts=calib_ts)
