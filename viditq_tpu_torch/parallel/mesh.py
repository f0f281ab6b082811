"""The device mesh and the Megatron sharding rules (port of
`viditq_tpu/parallel/mesh.py`).

A `Mesh` is this rank's view of the ranks of the default
`torch.distributed` group laid out as (dp, sp, tp, pp), in that order, as
the JAX package reshapes its devices (mesh.py:28-29): each axis's size,
this rank's coordinate along it, the process group of the ranks that
differ from it only along that axis, and their global ranks in axis
order. Without `torch.distributed` (one process) every axis has size 1 and
no group; the collectives of `parallel/comm.py` are then the identity.

`param_sharding_rules` is the JAX function as it is (it works on path
strings, here the port's dotted names with '.' read as '/').
`shard_params` cuts a state dict to this rank's tp shard by those rules,
with one departure from a contiguous cut: a packed kv kernel [C, 2C] (and
its bias) gives each rank the same heads of k and of v, where GSPMD cuts
the packed columns and reshards after the split. The column-parallel
biases are cut with their kernels (JAX replicates them and GSPMD slices
them: the same numbers). `data_sharding` and `replicated` become
`batch_slice` and `gather_batch`.

`init_distributed` starts the default group from torchrun's environment
(or an explicit init method): nccl for a CUDA device, gloo for the CPU,
unless the caller names another backend.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from viditq_tpu_torch.parallel import comm

AXES = ("dp", "sp", "tp", "pp")
# collectives that wait longer than this fail instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(backend: Optional[str] = None, device: str = "cuda",
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> Tuple[int, int]:
    """Start the default process group; returns (rank, world size).
    backend: nccl for a CUDA device, gloo for the CPU, unless given. Rank
    and world size come from torchrun's RANK / WORLD_SIZE (with
    init_method 'env://', its MASTER_ADDR / MASTER_PORT) unless given; a
    NCCL rank takes the card LOCAL_RANK names."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if rank is None or world_size is None:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            raise RuntimeError(
                "no rank and world size: run under torchrun (python -m "
                "torch.distributed.run) or pass rank and world_size")
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=timeout)
    return rank, world_size


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (dp, sp, tp, pp) mesh: `shape[axis]`, its
    `coord[axis]`, the `group(axis)` along that axis (None without
    torch.distributed) and `ranks[axis]`, that group's global ranks in
    axis order."""

    shape: Dict[str, int]
    coord: Dict[str, int]
    groups: Dict[str, object]
    ranks: Dict[str, Tuple[int, ...]]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, pp: int = 1,
              ranks: Optional[Sequence[int]] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT
              ) -> Optional[Mesh]:
    """The mesh over the first dp*sp*tp*pp of `ranks` (default: every rank
    of the default group), as JAX takes the first devices (mesh.py:23-30).
    Every rank of the default group must call it (it creates the groups);
    a rank outside the mesh gets None."""
    sizes = dict(zip(AXES, (dp, sp, tp, pp)))
    need = dp * sp * tp * pp
    if not dist.is_initialized():
        if need != 1:
            raise ValueError(f"need {need} ranks, have 1 (no "
                             "torch.distributed process group)")
        return Mesh(dict(sizes), {a: 0 for a in AXES},
                    {a: None for a in AXES}, {a: (0,) for a in AXES})
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if len(ranks) < need:
        raise ValueError(f"need {need} ranks, have {len(ranks)}")
    grid = np.asarray(ranks[:need]).reshape(dp, sp, tp, pp)
    me = dist.get_rank()
    hit = np.argwhere(grid == me)
    coord = ({a: int(c) for a, c in zip(AXES, hit[0])} if len(hit)
             else None)
    groups, members = {}, {}
    for ax, axis in enumerate(AXES):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
        for line in lines:
            line = tuple(int(r) for r in line)
            g = dist.new_group(list(line), timeout=timeout)
            if me in line:
                groups[axis], members[axis] = g, line
    if coord is None:
        return None
    return Mesh(dict(sizes), coord, groups, members)


def param_sharding_rules(path_str: str) -> Tuple[Optional[str], ...]:
    """Megatron-style TP weight sharding for DiT blocks (mesh.py:34-52):
    the PartitionSpec as a tuple. q/k/v/fc1/q_linear/kv_linear kernels
    [C_in, C_out] split on the output dim, proj/fc2 on the input dim,
    everything else replicated (); only layers under `blocks` split."""
    col = ("/q/", "/k/", "/v/", "/fc1/", "/q_linear/", "/kv_linear/")
    row = ("/proj/", "/fc2/")
    p = "/" + path_str.strip("/") + "/"
    if "/blocks" not in p and not p.startswith("/blocks"):
        return ()
    if any(c in p for c in col) and p.endswith("/kernel/"):
        return (None, "tp")
    if any(r in p for r in row) and p.endswith("/kernel/"):
        return ("tp", None)
    return ()


def tp_layout(name: str) -> Optional[Tuple[int, str]]:
    """(dim, kind) of a port parameter under tp, kind 'col', 'row' or 'kv'
    (the packed k|v columns), or None when replicated: the kernels by
    `param_sharding_rules`, and a column-parallel layer's bias with its
    kernel's columns."""
    path = name.replace(".", "/")
    leaf = path.rpartition("/")[2]
    spec = param_sharding_rules(path.rpartition("/")[0] + "/kernel")
    if spec == (None, "tp"):
        kind = "kv" if "/kv_linear" in "/" + path else "col"
        if leaf == "kernel":
            return 1, kind
        if leaf == "bias":
            return 0, kind
    if spec == ("tp", None) and leaf == "kernel":
        return 0, "row"
    return None


def _cut(t: torch.Tensor, dim: int, kind: str, rank: int, n: int):
    if kind == "kv":  # the same heads of k and of v
        k, v = t.chunk(2, dim=dim)
        return torch.cat([k.chunk(n, dim=dim)[rank],
                          v.chunk(n, dim=dim)[rank]], dim=dim)
    return t.chunk(n, dim=dim)[rank]


def shard_params(state: Mapping[str, torch.Tensor], mesh: Mesh
                 ) -> Dict[str, torch.Tensor]:
    """state cut to this rank's tp shard by `param_sharding_rules`
    (mesh.py:55-64); replicated entries pass as they are."""
    n, r = mesh.shape["tp"], mesh.coord["tp"]
    out = {}
    for name, t in state.items():
        lay = tp_layout(name) if n > 1 else None
        out[name] = t if lay is None else _cut(t, *lay, r, n).clone()
    return out


def gather_params(state: Mapping[str, torch.Tensor], mesh: Mesh
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of shard_params: every rank's tp shards joined."""
    n = mesh.shape["tp"]
    out = {}
    for name, t in state.items():
        lay = tp_layout(name) if n > 1 else None
        if lay is None:
            out[name] = t
            continue
        dim, kind = lay
        if kind == "kv":
            k, v = t.chunk(2, dim=dim)
            g = mesh.group("tp")
            out[name] = torch.cat([comm.all_gather(k, g, dim),
                                   comm.all_gather(v, g, dim)], dim=dim)
        else:
            out[name] = comm.all_gather(t, mesh.group("tp"), dim)
    return out


def batch_slice(t, mesh: Mesh, axis: str = "dp", dim: int = 0):
    """This rank's rows of t along dim, sharded over `axis` (JAX
    `data_sharding`, mesh.py:67-70); None passes."""
    n = mesh.shape[axis]
    if t is None or n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"batch {t.shape[dim]} not divisible by "
                         f"{axis}={n}")
    return t.chunk(n, dim=dim)[mesh.coord[axis]]


def gather_batch(t: torch.Tensor, mesh: Mesh, axis: str = "dp",
                 dim: int = 0) -> torch.Tensor:
    """The whole of a tensor batch-sharded over `axis`, on every rank
    (JAX `replicated`, mesh.py:73)."""
    if mesh.shape[axis] == 1:
        return t
    return comm.all_gather(t, mesh.group(axis), dim)
