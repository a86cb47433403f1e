"""Differentiable collectives over an explicit process group.

The sequence-parallel forward (`parallel.model_parallel`) moves activations
between the ranks of a seq group and backpropagates through them, as the JAX
package's ``shard_map`` body does with ``lax.all_gather``, ``psum_scatter``
and ``psum``. Each function here is a ``torch.autograd.Function`` whose
backward is the adjoint that JAX's transpose rules use:

* `all_gather` (concatenate the ranks' tensors along a dim): its backward
  is the sum reduce-scatter of the cotangent along that dim;
* `reduce_scatter` (sum the ranks' tensors, keep this rank's chunk of a
  dim): its backward is the all-gather;
* `all_reduce` (sum): its backward is the all-reduce of the cotangent.

On a group of one (or outside a process group, ``group=None``) each returns
its input. Every backend runs the same calls, on dim 0 (a dim other than 0
is moved to the front and back): list ``all_gather``, ``all_reduce``, and
the reduce-scatter as an all-reduce of which each rank keeps its chunk (the
one reduction that every gloo build takes, at twice the bytes of a
reduce-scatter). Only where the tensors travel follows the group's backend,
chosen in the open (`route`): on their own device for NCCL, through host
memory for gloo (a CUDA tensor is copied to the CPU and back; gloo is how
several ranks share one card, which NCCL refuses).

bf16 (and fp16) tensors travel and sum in fp32, and come back rounded once:
the same values whatever the backend. Every rank of the group gets the same
bits of a sum.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_WIRE = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


def group_size(group) -> int:
    """The ranks in ``group``; 1 for None or outside a process group."""
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's index in ``group``; 0 for None."""
    if group is None or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def route(group) -> str:
    """How the collectives of ``group`` run: "nccl" on the tensors' device,
    "gloo (host-staged)", or "local" for a group of one."""
    if group_size(group) == 1:
        return "local"
    backend = str(dist.get_backend(group))
    return "nccl" if backend == "nccl" else f"{backend} (host-staged)"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """A fresh contiguous copy of x as the collective of ``group`` takes it:
    on the host for a gloo group, in fp32 for a 16-bit type."""
    device = x.device if route(group) == "nccl" else torch.device("cpu")
    return x.detach().to(device=device, dtype=_WIRE.get(x.dtype, x.dtype), copy=True) \
        .contiguous()


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(device=like.device, dtype=like.dtype)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    buf = _wire(x.movedim(dim, 0), group)
    parts = [torch.empty_like(buf) for _ in range(group_size(group))]
    dist.all_gather(parts, buf, group=group)
    return _back(torch.cat(parts), x).movedim(0, dim)


def _scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, k = group_size(group), group_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {x.shape[dim]} does not split "
                         f"into {n} chunks")
    buf = _wire(x.movedim(dim, 0), group)
    chunk = buf.shape[0] // n
    dist.all_reduce(buf, group=group)
    return _back(buf[k * chunk:(k + 1) * chunk], x).movedim(0, dim)


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    buf = _wire(x, group)
    dist.all_reduce(buf, group=group)
    return _back(buf, x)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group: Optional[object]) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (JAX
    ``all_gather(..., tiled=True)``)."""
    return x if group_size(group) == 1 else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group: Optional[object]) -> torch.Tensor:
    """The ranks' ``x`` summed; this rank's chunk of ``dim`` (JAX
    ``psum_scatter(..., tiled=True)``)."""
    return x if group_size(group) == 1 else _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The ranks' ``x`` summed (JAX ``psum``)."""
    return x if group_size(group) == 1 else _AllReduce.apply(x, group)
