"""Fused prefill MoE wrappers (port of ``repro/kernels/moe_fused/ops.py``).

``gather_swiglu`` and ``down_combine`` are the two launches: plain versions
on CPU tensors, ``csrc/moe_fused.cu`` on ``cuda`` tensors, or an error.
:func:`fused_moe_fn` runs a :class:`~repro_torch.core.plans.DispatchPlan`
through both.  The kernel reads x (T, d) and treats index T as a zero row,
so the wrapper builds no padded copy of x.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.plans import DispatchPlan
from repro_torch.kernels.moe_fused import ref

_SIG = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"moe_fused: {msg}")


def _cuda_ready(tensors) -> None:
    dev = tensors[0].device
    _check(all(t.device == dev for t in tensors), "tensors on different devices")
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")


def gather_swiglu(
    x: torch.Tensor,         # (T, d)
    flat_idx: torch.Tensor,  # (E*C,) int32 token per slot, T = empty
    w_gate: torch.Tensor,    # (E, d, f)
    w_up: torch.Tensor,
) -> torch.Tensor:
    """h (E, C, f) = silu(x[idx] @ Wg) * (x[idx] @ Wu), in x's type."""
    T, d = x.shape
    E, d_, f = w_gate.shape
    _check(d_ == d and w_up.shape == w_gate.shape, f"w_gate/w_up shapes {tuple(w_gate.shape)}, {tuple(w_up.shape)}")
    _check(flat_idx.dtype == torch.int32 and flat_idx.ndim == 1 and flat_idx.numel() % E == 0,
           "flat_idx must be (E*C,) int32")
    _check(x.dtype == w_gate.dtype == w_up.dtype, "x and the expert stacks must share a dtype")
    C = flat_idx.numel() // E
    if x.device.type == "cpu":
        _check(all(t.device.type == "cpu" for t in (flat_idx, w_gate, w_up)), "tensors on different devices")
        return ref.gather_swiglu(x, flat_idx, w_gate, w_up)
    _cuda_ready((x, flat_idx, w_gate, w_up))
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    h = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    rc = function("moe_fused", "repro_gather_swiglu", _SIG)(
        dtype_code(x.dtype), ptr(x), ptr(flat_idx), ptr(w_gate), ptr(w_up), ptr(h),
        T, E, C, d, f, stream_of(x),
    )
    check_launch(rc, "gather_swiglu")
    gather_swiglu.launches += 1
    return h


gather_swiglu.launches = 0


def down_combine(
    h: torch.Tensor,         # (E, C, f)
    w_down: torch.Tensor,    # (E, f, d)
    flat_idx: torch.Tensor,  # (E*C,) int32 destination token per slot, T = empty
    slot_w: torch.Tensor,    # (E*C,) f32 combine weight per slot
    num_tokens: int,
) -> torch.Tensor:
    """y (T, d) f32 = sum over slots of slot_w * (h @ Wd), scattered by token."""
    E, C, f = h.shape
    d = w_down.shape[-1]
    _check(w_down.shape == (E, f, d), f"w_down shape {tuple(w_down.shape)}")
    _check(flat_idx.dtype == torch.int32 and flat_idx.shape == (E * C,), "flat_idx must be (E*C,) int32")
    _check(slot_w.dtype == torch.float32 and slot_w.shape == (E * C,), "slot_w must be (E*C,) f32")
    _check(h.dtype == w_down.dtype, "h and w_down must share a dtype")
    if h.device.type == "cpu":
        _check(all(t.device.type == "cpu" for t in (w_down, flat_idx, slot_w)), "tensors on different devices")
        return ref.down_combine(h, w_down, flat_idx, slot_w, num_tokens)
    _cuda_ready((h, w_down, flat_idx, slot_w))
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    out = torch.zeros((num_tokens, d), dtype=torch.float32, device=h.device)
    rc = function("moe_fused", "repro_down_combine", _SIG)(
        dtype_code(h.dtype), ptr(h), ptr(w_down), ptr(flat_idx), ptr(slot_w), ptr(out),
        num_tokens, E, C, d, f, stream_of(h),
    )
    check_launch(rc, "down_combine")
    down_combine.launches += 1
    return out


down_combine.launches = 0


def fused_moe_apply(x, flat_idx, slot_w, w_gate, w_up, w_down) -> torch.Tensor:
    """Full plan-steered expert pipeline, (T, d) -> (T, d), two launches."""
    h = gather_swiglu(x, flat_idx, w_gate, w_up)
    return down_combine(h, w_down, flat_idx, slot_w, x.shape[0]).to(x.dtype)


def fused_moe_fn(x: torch.Tensor, plan: DispatchPlan, p) -> torch.Tensor:
    """Plan-level entry point used by :func:`repro_torch.models.moe.moe_ffn`."""
    return fused_moe_apply(
        x.contiguous(), plan.flat_dispatch_idx().contiguous(), plan.flat_slot_w().contiguous(),
        p["w_gate"], p["w_up"], p["w_down"],
    )
