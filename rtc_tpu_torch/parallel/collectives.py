"""The collectives of sharded rendering, over one axis of the rank grid
(parallel/mesh.py Axis).

rtc_tpu's shard_map bodies call jax.lax.all_gather and psum; these are
their torch.distributed counterparts. Every rank of an axis group must
call the same collectives in the same order, so the callers decide
whether one runs from static facts (the config, the scene's static, the
shapes), never from a rank's own data.

The tensors stay on their device: on an H100 (torch 2.11) every gloo
collective used here takes CUDA tensors (gloo stages them through the
host itself), and NCCL takes them natively, so nothing is copied to the
host here. A backend that cannot do a collective raises from
torch.distributed; there is no detour.

COLLECTIVES counts the calls of each kind on this rank, and
COLLECTIVE_BYTES the bytes this rank contributed to them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Axis

COLLECTIVES = {"all_gather": 0, "all_reduce": 0}
COLLECTIVE_BYTES = {"all_gather": 0, "all_reduce": 0}


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
        COLLECTIVE_BYTES[k] = 0


def _count(kind: str, x: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += x.numel() * x.element_size()


def all_gather(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """(ax.size, *x.shape): every rank's x, in the order of the axis."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(out, x, group=ax.group)
    _count("all_gather", x)
    return torch.stack(out)


class _GatherReplicated(torch.autograd.Function):
    """all_gather whose result every rank of the axis consumes alike: the
    ranks compute one function of the gathered values, each a replica of
    it, so a rank's gradient of its own x is its own slice of the gathered
    gradient. (The gradient of a gather whose consumers differ per rank
    sums the slices over the ranks, a reduce-scatter, as
    torch.distributed.nn.functional.all_gather does; under replicated
    consumers that counts each gradient once per rank.)"""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.rank = ax.rank
        return all_gather(x.detach(), ax)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank], None


def all_gather_replicated(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """all_gather, differentiable where every rank of the axis consumes the
    result alike (_GatherReplicated)."""
    return _GatherReplicated.apply(x, ax)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, ax: Axis, op: str = "sum") -> torch.Tensor:
    """A copy of x reduced over the axis by op ('sum' or 'max'); x is left
    as it was."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=ax.group)
    _count("all_reduce", out)
    return out
