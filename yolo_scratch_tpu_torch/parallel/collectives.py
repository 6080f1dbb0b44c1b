"""Collectives of the data-parallel step, over ``torch.distributed``.

Each rank is one process; ``group`` is the process group of a mesh
(``parallel/mesh.py``), gloo or NCCL. Both take tensors on the rank's own
device (gloo copies CUDA tensors through host memory).

* :func:`all_reduce_sum`: a sum over the ranks that autograd sees through:
  its backward sums the incoming gradient over the ranks. Sync-BN reduces
  its per-channel count, sum and sum of squares through it, so the backward
  of every rank sees the global statistics' dependence on its own rows.
* :func:`all_reduce_grads`: one ``all_reduce`` a step over a flat copy of
  every ``.grad``; each ``.grad`` becomes a view of the reduced buffer.
* :func:`all_reduce_flat` / :func:`broadcast_flat`: the same flattening for
  buffers and state (one collective per dtype).
* :func:`all_gather_cat`: fixed-shape tensors of every rank, concatenated in
  rank order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, the same on every rank.
    Differentiable: the backward sums the gradient over the ranks (each
    rank's loss depends on every rank's ``x`` through the sum)."""
    return _AllReduceSum.apply(x, group)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def _copy_back(tensors: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
    torch._foreach_copy_(list(tensors), [p.view_as(t) for t, p in
                                         zip(tensors, flat.split([t.numel() for t in tensors]))])


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor], group, divide: int = 1) -> None:
    """Sum ``tensors`` over the ranks in place (divided by ``divide``: the
    mean over ``divide`` ranks), one ``all_reduce`` per dtype."""
    for ts in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if divide != 1:
            flat /= divide
        _copy_back(ts, flat)


@torch.no_grad()
def broadcast_flat(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s (a rank of the
    default group), one ``broadcast`` per dtype."""
    for ts in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        _copy_back(ts, flat)


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.nn.Parameter], group, divide: int = 1) -> None:
    """Sum every parameter's ``.grad`` over the ranks (divided by
    ``divide``) in one ``all_reduce`` of a flat buffer; each ``.grad``
    becomes a view of that buffer."""
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    if divide != 1:
        flat /= divide
    for p, part in zip(params, flat.split([p.numel() for p in params])):
        p.grad = part.view_as(p)


@torch.no_grad()
def all_gather_cat(x: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank (same shape on each), concatenated along ``dim``
    in rank order. Bool tensors travel as uint8."""
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out
