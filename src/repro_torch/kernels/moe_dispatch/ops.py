"""Dispatch and combine wrappers (port of ``repro/kernels/moe_dispatch/ops.py``).

:func:`dispatch` gathers (T, d) tokens into (E, C, d) expert slots and
:func:`combine` sums the (E, C, d) expert outputs back into (T, d) tokens
with the plan's weights.  Each is one launch of ``csrc/moe_dispatch.cu`` on
``cuda`` tensors (counted in ``launches``), its plain version (``ref.py``) on
CPU tensors, or an error.  The kernels read the plan's flat control words:
slot index T is the zero row (the wrapper builds no padded copy of x) and
assignment index E*C is a dropped one.
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
    T, d = x.shape
    E, C = plan.num_experts, plan.capacity
    idx = plan.flat_dispatch_idx()
    _check(idx.dtype == torch.int32 and idx.shape == (E * C,), "flat dispatch index must be (E*C,) int32")
    if x.device.type == "cpu":
        _check(idx.device.type == "cpu", "tensors on different devices")
        return ref.dispatch(x, plan)
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
    T, k = plan.combine_idx.shape
    _check((E, C) == (plan.num_experts, plan.capacity), f"slots {tuple(y_slots.shape)} do not fit the plan's "
           f"({plan.num_experts}, {plan.capacity}) slots")
    cidx, w = plan.flat_combine_words()
    _check(cidx.dtype == torch.int32 and w.dtype == torch.float32, "combine words must be int32 and f32")
    if y_slots.device.type == "cpu":
        _check(cidx.device.type == "cpu" and w.device.type == "cpu", "tensors on different devices")
        return ref.combine(y_slots, plan)
    _check(k <= KMAX, f"top_k {k} exceeds the kernel's {KMAX}")
    y_slots, cidx, w = y_slots.contiguous(), cidx.contiguous(), w.contiguous()
    _cuda_ready((y_slots, cidx, w))
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    out = torch.empty((T, d), dtype=y_slots.dtype, device=y_slots.device)
    rc = function("moe_dispatch", "repro_moe_combine", [ctypes.c_int] + [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])(
        dtype_code(y_slots.dtype), ptr(y_slots), ptr(cidx), ptr(w), ptr(out), T, E * C, k, d,
        _vectorised(d, y_slots, out), stream_of(y_slots),
    )
    check_launch(rc, "moe_combine")
    combine.launches += 1
    return out


combine.launches = 0
