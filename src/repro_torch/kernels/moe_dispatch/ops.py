"""Dispatch and combine wrappers (port of ``repro/kernels/moe_dispatch/ops.py``).

:func:`dispatch` gathers (T, d) tokens into (E, C, d) expert slots and
:func:`combine` sums the (E, C, d) expert outputs back into (T, d) tokens
with the plan's weights.  Each is one launch of ``csrc/moe_dispatch.cu`` on
``cuda`` tensors (counted in ``launches``), its plain version (``ref.py``) on
CPU tensors, or an error.  The kernels read the plan's flat control words:
slot index T is the zero row (the wrapper builds no padded copy of x) and
assignment index E*C is a dropped one.

Under autograd (:func:`dispatch_fn`, :func:`combine_fn`, the expert-parallel
a2a body's training path) dispatch's backward is :func:`dispatch_bwd`, the
combine kernel over the plan's combine words with unit weights (counted as
its own launches), and combine's is :func:`combine_bwd`, the 10_bwd launch of
``csrc/moe_dispatch.cu``: the slots' gradient and the weights' (which
reaches the router through the plan's combine weights).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.plans import DispatchPlan
from repro_torch.kernels.moe_dispatch import ref

KMAX = 32  # top_k the combine kernel takes


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"moe_dispatch: {msg}")


def _cuda_ready(tensors) -> None:
    dev = tensors[0].device
    _check(all(t.device == dev for t in tensors), "tensors on different devices")
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")


def _vectorised(d: int, *rows: torch.Tensor) -> int:
    """1 when every row of ``d`` elements is a whole number of aligned
    16-byte vectors, else 0 (the kernels then move scalars)."""
    return int((d * rows[0].element_size()) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in rows))


def dispatch(x: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """slots (E, C, d) with ``slots[e, c] = x[dispatch_idx[e, c]]`` and zero
    rows for empty slots, in x's type."""
    E, C = plan.num_experts, plan.capacity
    idx = plan.flat_dispatch_idx()
    _check(idx.dtype == torch.int32 and idx.shape == (E * C,), "flat dispatch index must be (E*C,) int32")
    if x.device.type == "cpu":
        _check(idx.device.type == "cpu", "tensors on different devices")
        return ref.dispatch(x, plan)
    return _dispatch_words(x, idx, E, C)


def _dispatch_words(x: torch.Tensor, idx: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """Kernel 9 on the flat slot index ``idx`` (E*C,) (T = empty), counted
    in ``dispatch.launches``; its plain version on CPU tensors."""
    T, d = x.shape
    if x.device.type == "cpu":
        _check(idx.device.type == "cpu", "tensors on different devices")
        return ref.dispatch_words(x, idx, E, C)
    x, idx = x.contiguous(), idx.contiguous()
    _cuda_ready((x, idx))
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    slots = torch.empty((E, C, d), dtype=x.dtype, device=x.device)
    rc = function("moe_dispatch", "repro_moe_dispatch", [ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])(
        dtype_code(x.dtype), ptr(x), ptr(idx), ptr(slots), T, E * C, d, _vectorised(d, x, slots), stream_of(x),
    )
    check_launch(rc, "moe_dispatch")
    dispatch.launches += 1
    return slots


dispatch.launches = 0


def combine(y_slots: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """y (T, d) with ``y[t] = sum_j w[t, j] * y_slots[combine_idx[t, j]]``,
    dropped assignments adding nothing; summed in f32 in the order
    j = 0..k-1, in ``y_slots``' type."""
    E, C, d = y_slots.shape
    T = plan.combine_idx.shape[0]
    _check((E, C) == (plan.num_experts, plan.capacity), f"slots {tuple(y_slots.shape)} do not fit the plan's "
           f"({plan.num_experts}, {plan.capacity}) slots")
    cidx, w = plan.flat_combine_words()
    _check(cidx.dtype == torch.int32 and w.dtype == torch.float32, "combine words must be int32 and f32")
    if y_slots.device.type == "cpu":
        _check(cidx.device.type == "cpu" and w.device.type == "cpu", "tensors on different devices")
        return ref.combine(y_slots, plan)
    _words_ok(T, cidx, w)
    return _combine_words(y_slots.reshape(E * C, d), cidx, w, T)


def _combine_words(y_flat: torch.Tensor, cidx: torch.Tensor, w: torch.Tensor, T: int) -> torch.Tensor:
    """Kernel 10 on the flat combine words, counted in ``combine.launches``;
    its plain version on CPU tensors."""
    if y_flat.device.type == "cpu":
        _check(cidx.device.type == "cpu" and w.device.type == "cpu", "tensors on different devices")
        return ref.combine_words(y_flat, cidx, w, T)
    out = _combine_launch(y_flat, cidx, w, T)
    combine.launches += 1
    return out


combine.launches = 0


def _combine_launch(y_flat: torch.Tensor, cidx: torch.Tensor, w: torch.Tensor, T: int) -> torch.Tensor:
    """Kernel 10's one launch site: the flat words on the card, y (T, d);
    the caller counts the launch (as a combine, or as dispatch's backward)."""
    y_flat, cidx, w = y_flat.contiguous(), cidx.contiguous(), w.contiguous()
    _cuda_ready((y_flat, cidx, w))
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    n, d = y_flat.shape
    k = cidx.numel() // T
    out = torch.empty((T, d), dtype=y_flat.dtype, device=y_flat.device)
    rc = function("moe_dispatch", "repro_moe_combine", [ctypes.c_int] + [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])(
        dtype_code(y_flat.dtype), ptr(y_flat), ptr(cidx), ptr(w), ptr(out), T, n, k, d,
        _vectorised(d, y_flat, out), stream_of(y_flat),
    )
    check_launch(rc, "moe_combine")
    return out


def _words_ok(T: int, cidx: torch.Tensor, w: torch.Tensor = None) -> int:
    _check(cidx.dtype == torch.int32 and cidx.ndim == 1 and T > 0 and cidx.numel() % T == 0,
           "combine words must be (T*k,) int32")
    _check(w is None or (w.dtype == torch.float32 and w.shape == cidx.shape), "combine weights must be (T*k,) f32")
    k = cidx.numel() // T
    _check(k <= KMAX, f"top_k {k} exceeds the kernel's {KMAX}")
    return k


def dispatch_bwd(dslots: torch.Tensor, cidx: torch.Tensor, T: int) -> torch.Tensor:
    """Kernel 9's backward: dx (T, d) with ``dx[t]`` the sum of its slots'
    rows of ``dslots`` (E, C, d) in ascending j of the combine words ``cidx``
    (T*k,) (E*C = dropped), in dslots' type.  Every kept slot belongs to one
    (t, j) and a dropped assignment adds nothing, so this is kernel 10 with
    unit weights: one launch of ``repro_moe_combine``, counted here."""
    E, C, d = dslots.shape
    _words_ok(T, cidx)
    flat = dslots.reshape(E * C, d)
    if dslots.device.type == "cpu":
        _check(cidx.device.type == "cpu", "tensors on different devices")
        return ref.dispatch_bwd(flat, cidx, T)
    out = _combine_launch(flat, cidx, torch.ones(cidx.shape, dtype=torch.float32, device=cidx.device), T)
    dispatch_bwd.launches += 1
    return out


dispatch_bwd.launches = 0


def combine_bwd(dy: torch.Tensor, y_slots: torch.Tensor, cidx: torch.Tensor, w: torch.Tensor,
                flat_idx: torch.Tensor):
    """Kernel 10's backward (10_bwd) for the gradient dy (T, d) of
    ``combine``: ``(dslots (E, C, d), dw (T*k,) f32)``, dslots[cidx[t, j]] =
    w[t, j] dy[t] in the slots' type with zero rows in the empty slots
    (``flat_idx`` (E*C,), T = empty), dw[t, j] = <dy[t], y_slots[cidx[t, j]]>
    summed in f32 (0 for a dropped assignment).  One launch on the card."""
    E, C, d = y_slots.shape
    T = dy.shape[0]
    _words_ok(T, cidx, w)
    _check(dy.shape == (T, d) and dy.dtype == y_slots.dtype, f"dy must be ({T}, {d}) {y_slots.dtype}")
    _check(flat_idx.dtype == torch.int32 and flat_idx.shape == (E * C,), "flat_idx must be (E*C,) int32")
    flat = y_slots.reshape(E * C, d)
    if y_slots.device.type == "cpu":
        _check(all(t.device.type == "cpu" for t in (dy, cidx, w, flat_idx)), "tensors on different devices")
        dslots, dw = ref.combine_bwd(dy, flat, cidx, w, flat_idx)
        return dslots.reshape(E, C, d), dw
    dy, flat, cidx, w, flat_idx = (t.contiguous() for t in (dy, flat, cidx, w, flat_idx))
    _cuda_ready((dy, flat, cidx, w, flat_idx))
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    k = cidx.numel() // T
    dslots = torch.empty_like(flat)
    dw = torch.empty(cidx.shape, dtype=torch.float32, device=dy.device)
    rc = function("moe_dispatch", "repro_moe_combine_bwd", [ctypes.c_int] + [ctypes.c_void_p] * 7
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])(
        dtype_code(dy.dtype), ptr(dy), ptr(flat), ptr(cidx), ptr(w), ptr(flat_idx), ptr(dslots), ptr(dw),
        T, E * C, k, d, _vectorised(d, dy, flat, dslots), stream_of(dy),
    )
    check_launch(rc, "moe_combine_bwd")
    combine_bwd.launches += 1
    return dslots.view(E, C, d), dw


combine_bwd.launches = 0


class _Dispatch(torch.autograd.Function):
    """Kernel 9 with its gradient (:func:`dispatch_bwd`)."""

    @staticmethod
    def forward(ctx, x, flat_idx, cidx, E, C):
        ctx.save_for_backward(cidx)
        ctx.T = x.shape[0]
        return _dispatch_words(x, flat_idx, E, C)

    @staticmethod
    def backward(ctx, dslots):
        (cidx,) = ctx.saved_tensors
        return dispatch_bwd(dslots.contiguous(), cidx, ctx.T), None, None, None, None


class _Combine(torch.autograd.Function):
    """Kernel 10 with its gradient (:func:`combine_bwd`): the slots' and the
    combine weights'."""

    @staticmethod
    def forward(ctx, y_slots, w, cidx, flat_idx, T):
        ctx.save_for_backward(y_slots, w, cidx, flat_idx)
        E, C, d = y_slots.shape
        return _combine_words(y_slots.reshape(E * C, d), cidx, w, T)

    @staticmethod
    def backward(ctx, dy):
        y_slots, w, cidx, flat_idx = ctx.saved_tensors
        dslots, dw = combine_bwd(dy.contiguous(), y_slots, cidx, w, flat_idx)
        return dslots, dw, None, None, None


def dispatch_fn(x: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """:func:`dispatch` under autograd: x's gradient from :func:`dispatch_bwd`."""
    E, C = plan.num_experts, plan.capacity
    idx = plan.flat_dispatch_idx()
    _check(idx.dtype == torch.int32 and idx.shape == (E * C,), "flat dispatch index must be (E*C,) int32")
    cidx, _ = plan.flat_combine_words()
    return _Dispatch.apply(x.contiguous(), idx.contiguous(), cidx.contiguous(), E, C)


def combine_fn(y_slots: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """:func:`combine` under autograd: the slots' and the combine weights'
    gradients from :func:`combine_bwd` (the weights' reaches the router)."""
    E, C, d = y_slots.shape
    T = plan.combine_idx.shape[0]
    _check((E, C) == (plan.num_experts, plan.capacity), f"slots {tuple(y_slots.shape)} do not fit the plan's "
           f"({plan.num_experts}, {plan.capacity}) slots")
    cidx, w = plan.flat_combine_words()
    _words_ok(T, cidx, w)
    return _Combine.apply(y_slots.contiguous(), w.contiguous(), cidx.contiguous(),
                          plan.flat_dispatch_idx().contiguous(), T)
