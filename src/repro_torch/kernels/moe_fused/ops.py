"""Fused prefill MoE wrappers (port of ``repro/kernels/moe_fused/ops.py``).

``gather_swiglu`` and ``down_combine`` are the two launches: plain versions
on CPU tensors, ``csrc/moe_fused.cu`` on ``cuda`` tensors, or an error.  On
the card each takes one of two builds, named by :func:`gather_swiglu_path`
and :func:`down_combine_path`: bf16 with d and f multiples of 8 on tensor
cores (wgmma; weights by TMA, and for ``gather_swiglu`` the slots' rows
gathered by cp.async, for ``down_combine`` h's slot tiles by TMA),
everything else on CUDA cores.
:func:`fused_moe_fn` runs a :class:`~repro_torch.core.plans.DispatchPlan`
through both.  The kernel reads x (T, d) and treats index T as a zero row,
so the wrapper builds no padded copy of x.  :func:`fused_experts_fn` runs
slots that are already expert-major (the expert-parallel a2a body's
post-all_to_all tensor) through ``gather_swiglu`` over the identity index
and the grouped GEMM (:mod:`repro_torch.kernels.grouped_gemm`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.plans import DispatchPlan
from repro_torch.kernels.moe_fused import ref

_SIG = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIG_TC = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIG_DOWN = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIG_DOWN_TC = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"moe_fused: {msg}")


def _cuda_ready(tensors) -> None:
    dev = tensors[0].device
    _check(all(t.device == dev for t in tensors), "tensors on different devices")
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")


def gather_swiglu_path(dtype: torch.dtype, d: int, f: int, aligned: bool) -> str:
    """Which build of kernel 3 a launch takes, from its dtype, d, f and
    whether x, the stacks and h start on 16-byte boundaries:
    ``"tensor_cores"`` (bf16 wgmma tiles; TMA and the 16-byte gather need
    d and f multiples of 8) or ``"cuda_cores"`` (f32 products; f32, and
    bf16 at any other shape)."""
    ok = dtype == torch.bfloat16 and d > 0 and d % 8 == 0 and f % 8 == 0 and aligned
    return "tensor_cores" if ok else "cuda_cores"


def down_combine_path(dtype: torch.dtype, f: int, d: int, aligned: bool) -> str:
    """Which build of kernel 4 a launch takes, from its dtype, f, d and
    whether h and the stack start on 16-byte boundaries: ``"tensor_cores"``
    (bf16 wgmma tiles fed by TMA, which needs h's and Wd's row strides
    multiples of 16 bytes: f and d multiples of 8) or ``"cuda_cores"`` (f32
    products; f32, and bf16 at any other shape)."""
    ok = dtype == torch.bfloat16 and f > 0 and f % 8 == 0 and d % 8 == 0 and aligned
    return "tensor_cores" if ok else "cuda_cores"


def gather_swiglu(
    x: torch.Tensor,         # (T, d)
    flat_idx: torch.Tensor,  # (E*C,) int32 token per slot, T = empty
    w_gate: torch.Tensor,    # (E, d, f)
    w_up: torch.Tensor,
) -> torch.Tensor:
    """h (E, C, f) = silu(x[idx] @ Wg) * (x[idx] @ Wu), in x's type.  On
    the card the launch takes the build :func:`gather_swiglu_path` names."""
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w_gate, w_up, h))
    if gather_swiglu_path(x.dtype, d, f, aligned) == "tensor_cores":
        rc = function("moe_fused", "repro_gather_swiglu_tc", _SIG_TC)(
            ptr(x), ptr(flat_idx), ptr(w_gate), ptr(w_up), ptr(h), T, E, C, d, f, stream_of(x))
    else:
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
    """y (T, d) f32 = sum over slots of slot_w * (h @ Wd), scattered by
    token.  On the card the down product takes the build
    :func:`down_combine_path` names and writes the occupied slots' weighted
    rows to an (E*C, d) f32 scratch; a second launch sums each token's rows
    in a fixed order (ascending slot), so the result is bitwise repeatable
    (two CUDA launches, counted as one)."""
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

    rows = torch.empty((E * C, d), dtype=torch.float32, device=h.device)
    out = torch.empty((num_tokens, d), dtype=torch.float32, device=h.device)
    args = (ptr(h), ptr(w_down), ptr(flat_idx), ptr(slot_w), ptr(rows), ptr(out), num_tokens, E, C, d, f,
            stream_of(h))
    if down_combine_path(h.dtype, f, d, h.data_ptr() % 16 == 0 and w_down.data_ptr() % 16 == 0) == "tensor_cores":
        rc = function("moe_fused", "repro_down_combine_tc", _SIG_DOWN_TC)(*args)
    else:
        rc = function("moe_fused", "repro_down_combine", _SIG_DOWN)(dtype_code(h.dtype), *args)
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


def fused_experts_fn(x_slots: torch.Tensor, p) -> torch.Tensor:
    """``experts_fn`` over expert-major slots (E, C, d) -> (E, C, d): one
    ``gather_swiglu`` launch over the identity index (every slot occupied, so
    every expert's gate/up weights are read) and one grouped down projection;
    the output stays slot-major, no scatter (reference
    ``moe_fused/ops.fused_experts_fn``)."""
    from repro_torch.kernels.grouped_gemm import grouped_gemm

    E, C, d = x_slots.shape
    flat_idx = torch.arange(E * C, dtype=torch.int32, device=x_slots.device)
    h = gather_swiglu(x_slots.reshape(E * C, d).contiguous(), flat_idx, p["w_gate"], p["w_up"])
    return grouped_gemm(h, p["w_down"].to(h.dtype)).to(x_slots.dtype)
