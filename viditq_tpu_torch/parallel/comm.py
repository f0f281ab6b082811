"""The collectives of the port's parallelism, over `torch.distributed`
groups (the JAX package's `jax.lax` collectives inside `shard_map`:
`all_to_all`, `ppermute`, `psum`, and GSPMD's gathers).

A group whose backend is gloo runs on host tensors: a CUDA tensor handed
to one is copied to the host, the collective runs there, and the result is
copied back (`_on_host`). That is how two ranks share one card, since NCCL
refuses two ranks on one device; a NCCL group takes the tensors where they
are. Every function takes `group=None` as a group of one rank (no
`torch.distributed` at all): the collective is then the identity.

`copy_to_group` and `reduce_from_group` are Megatron's conjugate pair for
tensor parallelism (the identity forward with a summed gradient, the sum
forward with the gradient passed as it is): a loss computed alike on every
rank of the group then gets every gradient once. (`torch.distributed.nn.
functional.all_reduce` sums the gradient too, which counts a replicated
loss's gradient once per rank.)
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _on_host(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _staged(group, t: torch.Tensor) -> torch.Tensor:
    """t as the group's backend takes it: on the host for gloo."""
    t = t.contiguous()
    return t.cpu() if _on_host(group, t) else t


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """Reduce t over the group by op (a sum by default), in place; returns
    t."""
    if group is None:
        return t
    s = _staged(group, t)
    dist.all_reduce(s, op=op, group=group)
    if s is not t:
        t.copy_(s)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """t of global rank src on every rank of the group, in place."""
    if group is None:
        return t
    s = _staged(group, t)
    dist.broadcast(s, src=src, group=group)
    if s is not t:
        t.copy_(s)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along dim in group-rank order."""
    if group is None:
        return t
    s = _staged(group, t)
    parts = [torch.empty_like(s) for _ in range(group_size(group))]
    dist.all_gather(parts, s, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_to_all(t: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """jax.lax.all_to_all(tiled=True): t cut into group-size chunks along
    split_dim, chunk j sent to group rank j; the chunks received are
    concatenated along concat_dim in group-rank order."""
    n = group_size(group)
    if group is None:
        return t
    if t.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not "
                         f"split into {n}")
    send = _staged(group, torch.stack(t.chunk(n, dim=split_dim)))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim).to(t.device)


def send(t: torch.Tensor, dst: int, group, tag: int = 0) -> None:
    """t to global rank dst (blocking)."""
    dist.send(_staged(group, t), dst=dst, group=group, tag=tag)


def recv(shape, dtype, device, src: int, group, tag: int = 0
         ) -> torch.Tensor:
    """A tensor of shape and dtype from global rank src, on device."""
    probe = torch.empty(shape, dtype=dtype, device=device)
    buf = _staged(group, probe)
    dist.recv(buf, src=src, group=group, tag=tag)
    return buf.to(device)


def shift(t: torch.Tensor, group, ranks: List[int]) -> torch.Tensor:
    """jax.lax.ppermute with perm [(d, (d + 1) % n)]: every rank sends t
    to the rank after it in `ranks` (the group's global ranks in group
    order) and returns what the rank before it sent."""
    n = len(ranks)
    if group is None or n == 1:
        return t
    me = ranks.index(dist.get_rank())
    s = _staged(group, t)
    out = torch.empty_like(s)
    ops = [dist.P2POp(dist.isend, s, ranks[(me + 1) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(me - 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; its gradient summed over the group (the input of a
    column-parallel layer)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group; its gradient passed as it is (the output of
    a row-parallel layer)."""
    return x if group is None else _ReduceFromGroup.apply(x, group)
