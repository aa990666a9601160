"""Collectives over a port :class:`~repro_torch.launch.mesh.Mesh` (port of
``repro/parallel/collectives.py``), and the differentiable collectives the
sharded train step and the expert-parallel bodies run under autograd.

* :func:`compressed_psum`: int8 all-reduce for the inter-pod hop, with one
  f32 scale shared by every member (the control word: the max of the
  members' amax, reduced first);
* :func:`hierarchical_grad_sync`: full-precision all-reduce over the
  intra-pod data axes, then over ``pod`` (compressed or exact), then the
  mean;
* :func:`tree_bytes` / :func:`control_bytes`: byte accounting of trees.

Every function takes the mesh's process groups (``mesh.group(axis)``);
every rank calls it with the same arguments, in the same order.

The differentiable collectives (:func:`gather`, :func:`split`,
:func:`sum_grad`, :func:`psum`, :func:`all_to_all`, :func:`pmean`) each have
the backward that is right for how their tensors are replicated, which
``torch.distributed.nn.functional`` (whose collectives sum in backward)
does not give.  The expert-parallel bodies and the ``tp`` step use the
replicated convention: a tensor that every rank of a group holds whole (the
output of a dense layer computed on every ``model`` rank) has its whole
gradient on every rank, so a gather's backward keeps the rank's own slice
and sums nothing.  The ``fsdp`` step's gathers pass ``reduce=True``: there
each rank's cotangent is a part of the sum (its own rows), and the
backward is a reduce-scatter.  On the card a collective issued from the
backward (autograd's own thread) runs with the tensor's device current.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.quant import dequantize_int8

__all__ = [
    "compressed_psum",
    "hierarchical_grad_sync",
    "tree_bytes",
    "control_bytes",
    "gather",
    "split",
    "sum_grad",
    "psum",
    "all_to_all",
    "pmean",
    "all_gather_dim",
    "reduce_scatter_dim",
]


def _device_of(t: torch.Tensor):
    """The tensor's device made current (a collective issued on autograd's
    thread, where no device may be set yet), or nothing on the CPU."""
    return torch.cuda.device(t.device) if t.device.type == "cuda" else contextlib.nullcontext()


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """int8 all-reduce with a SHARED scale: the max of the members' amax
    first (a scalar, the control word), every member quantized against it,
    summed in int32 (no overflow below 2^23 members), rescaled.  Wire
    bytes: 1/4 of f32.  Returns a new tensor in x's type."""
    with _device_of(x):
        amax = x.detach().abs().max().to(torch.float32).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        amax = amax[0]
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
        total = q.to(torch.int32)
        dist.all_reduce(total, group=group)
        return dequantize_int8(total, scale, x.dtype)


def hierarchical_grad_sync(
    grads: Any,
    mesh,
    *,
    intra_axes: Sequence[str] = ("data",),
    inter_axis: Optional[str] = "pod",
    compress_inter: bool = True,
    mean: bool = True,
    inplace: bool = False,
) -> Any:
    """Two-level gradient reduction over ``mesh``, leaf by leaf of a tree of
    dicts and lists of tensors:

    1. full-precision all-reduce over each of ``intra_axes`` (fast links),
    2. over ``inter_axis`` (``None``: none), int8-compressed
       (:func:`compressed_psum`) or exact,
    3. with ``mean``, division by the product of those axes' sizes on the
       mesh.

    Returns a new tree, or with ``inplace`` writes the leaves in place (the
    train step's gradients) and returns ``grads``."""
    axes = list(intra_axes) + ([inter_axis] if inter_axis else [])
    n = 1
    for a in axes:
        n *= int(mesh.shape.get(a, 1))

    def sync(g: torch.Tensor) -> torch.Tensor:
        out = g if inplace else g.clone()
        with _device_of(out):
            for a in intra_axes:
                dist.all_reduce(out, group=mesh.group(a))
            if inter_axis is not None:
                if compress_inter:
                    out.copy_(compressed_psum(out, mesh.group(inter_axis)))
                else:
                    dist.all_reduce(out, group=mesh.group(inter_axis))
        if mean and n != 1:
            out.div_(n)
        return out

    return _tree_map(sync, grads)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor leaf of a tree of dicts and lists."""
    return sum(int(t.numel()) * t.element_size() for t in _leaves(tree))


def control_bytes(plan_like: Any) -> int:
    """Bytes of control-plane tensors (dispatch plans, masks, schedules)."""
    return tree_bytes(plan_like)


# ---------------------------------------------------------------------------
# plain collectives along a tensor dimension
# ---------------------------------------------------------------------------


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's shards of ``dim`` concatenated in group-rank order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    with _device_of(x):
        out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.view(n, *x.shape).unbind(0), dim=dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's shard of ``dim`` (its
    group rank's block): one reduce-scatter (NCCL on the card, gloo on the
    CPU)."""
    n = dist.get_world_size(group)
    with _device_of(x):
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return reduce_scatter_dim(g, ctx.group, ctx.dim), None, None, None
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        size = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, r * size, size).contiguous(), None, None, None


def gather(x: torch.Tensor, group, dim: int, *, reduce: bool = False) -> torch.Tensor:
    """All-gather along ``dim`` (shards in group-rank order).  Backward: the
    rank's own slice of the (replicated) cotangent, or with ``reduce`` the
    reduce-scatter of the (partial) cotangents."""
    return _Gather.apply(x, group, dim, reduce)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        size = x.shape[dim] // n
        return x.narrow(dim, r * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.group, ctx.dim), None, None


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of a tensor the group holds whole.
    Backward: the blocks' gradients all-gathered, so the whole tensor's
    gradient is on every rank."""
    return _Split.apply(x, group, dim)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        with _device_of(g):
            dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward the all-reduce of the gradient: for a
    tensor the group holds whole that each rank uses for its own part of
    the work (a router on its sequence chunk), so each rank's gradient is a
    part of the sum."""
    return _SumGrad.apply(x, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        with _device_of(out):
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) of partial results; backward the identity (the sum
    is replicated, so its gradient is the whole one on every rank)."""
    return _Psum.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        with _device_of(x):
            dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        with _device_of(g):
            dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of equal blocks of dim 0 (block j to rank j);
    backward the same exchange of the gradient's blocks (the permutation's
    transpose)."""
    return _AllToAll.apply(x, group)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, grad_scale):
        ctx.grad_scale = grad_scale
        out = x.contiguous().clone()
        with _device_of(out):
            dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None, None


def pmean(x: torch.Tensor, group, n: int, grad_scale: float = 1.0) -> torch.Tensor:
    """The mean over the group; backward the cotangent times
    ``grad_scale``: the caller's share of a mean whose copies its peers'
    gradients also carry (1 / ep for the aux losses of the a2a body, whose
    ``model`` ranks each hold the loss; the data axes' share comes with the
    step's mean over them)."""
    return _PMean.apply(x, group, n, grad_scale)
