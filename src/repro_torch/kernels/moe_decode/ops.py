"""Decode MoE wrappers (port of ``repro/kernels/moe_decode/ops.py``).

:func:`decode_moe_kernel` is the launch: plain version on CPU tensors,
``csrc/moe_decode.cu`` (two CUDA launches per call, counted as one) on
``cuda`` tensors, or an error.  :func:`decode_moe` executes a
:class:`~repro_torch.core.plans.DecodePlan` over a layer's expert stacks.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.plans import DecodePlan
from repro_torch.kernels.moe_decode import ref


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_moe: {msg}")


def decode_moe_kernel(
    x: torch.Tensor,           # (T, d)
    expert_ids: torch.Tensor,  # (T, k) int32
    weights: torch.Tensor,     # (T, k) f32
    w_gate: torch.Tensor,      # (E, d, f)
    w_up: torch.Tensor,
    w_down: torch.Tensor,      # (E, f, d)
    scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plan-steered decode MoE, (T, d) -> (T, d) f32."""
    if scales is not None:
        raise NotImplementedError("int8 expert stacks (per-expert scales) are ported in a later slice")
    T, d = x.shape
    _check(expert_ids.ndim == 2 and expert_ids.shape[0] == T, f"expert_ids shape {tuple(expert_ids.shape)}")
    k = expert_ids.shape[1]
    E, d_, f = w_gate.shape
    _check(d_ == d and w_up.shape == w_gate.shape, f"w_gate/w_up shapes {tuple(w_gate.shape)}, {tuple(w_up.shape)}")
    _check(w_down.shape == (E, f, d), f"w_down shape {tuple(w_down.shape)}")
    _check(weights.shape == expert_ids.shape, "weights and expert_ids shapes differ")
    _check(expert_ids.dtype == torch.int32 and weights.dtype == torch.float32, "plan must be int32 ids, f32 weights")
    _check(x.dtype == w_gate.dtype == w_up.dtype == w_down.dtype, "x and the expert stacks must share a dtype")
    dev = x.device
    _check(all(t.device == dev for t in (expert_ids, weights, w_gate, w_up, w_down)), "tensors on different devices")
    if dev.type == "cpu":
        return ref.decode_moe(x, expert_ids, weights, w_gate, w_up, w_down)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    _check(all(t.is_contiguous() for t in (x, expert_ids, weights, w_gate, w_up, w_down)), "tensors must be contiguous")
    fn = function(
        "moe_decode", "repro_decode_moe",
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    h = torch.empty((T * k, f), dtype=torch.float32, device=dev)
    out = torch.empty((T, d), dtype=torch.float32, device=dev)
    rc = fn(
        dtype_code(x.dtype), ptr(x), ptr(expert_ids), ptr(weights), ptr(w_gate), ptr(w_up), ptr(w_down),
        ptr(h), ptr(out), T, k, d, f, stream_of(x),
    )
    check_launch(rc, "decode_moe")
    decode_moe_kernel.launches += 1
    return out


decode_moe_kernel.launches = 0


def decode_moe(x: torch.Tensor, plan: DecodePlan, p) -> torch.Tensor:
    """Execute a (T_total, k) DecodePlan on layer params ``p`` (``w_gate``,
    ``w_up``, ``w_down``); (T, d) -> (T, d) in x's type."""
    y = decode_moe_kernel(
        x.contiguous(), plan.expert_ids.contiguous(), plan.weights.contiguous(),
        p["w_gate"], p["w_up"], p["w_down"],
    )
    return y.to(x.dtype)
