"""Decode MoE wrappers (port of ``repro/kernels/moe_decode/ops.py``).

:func:`decode_moe_kernel` is the launch: plain version on CPU tensors,
``csrc/moe_decode.cu`` (three CUDA launches per call, counted as one: gate/up
and down over the plan's experts, grouped on the card, then each token's k
rows summed in order) on ``cuda`` tensors, or an error.  It reads nothing
back to the host.  Its int8 branch (int8 stacks with per-expert
scales) counts its launches apart, in ``int8_launches``; on a ``cuda``
tensor it launches the int8 kernel or raises, never dequantizing first.
:func:`decode_moe` executes a :class:`~repro_torch.core.plans.DecodePlan`
over a layer's expert stacks.
"""
from __future__ import annotations

import ctypes

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
    w_gate: torch.Tensor,      # (E, d, f); int8 with scales
    w_up: torch.Tensor,
    w_down: torch.Tensor,      # (E, f, d)
    scales=None,  # (gate, up, down) per-expert (E,) f32 scales of int8 stacks, or (3, E)
) -> torch.Tensor:
    """Plan-steered decode MoE, (T, d) -> (T, d) f32.  With ``scales`` the
    stacks are int8 (the int8 branch: each weight element is multiplied by
    its expert's scale before it meets x) and x is f32 or bf16; without,
    x and the stacks share f32 or bf16."""
    T, d = x.shape
    _check(expert_ids.ndim == 2 and expert_ids.shape[0] == T, f"expert_ids shape {tuple(expert_ids.shape)}")
    k = expert_ids.shape[1]
    E, d_, f = w_gate.shape
    _check(d_ == d and w_up.shape == w_gate.shape, f"w_gate/w_up shapes {tuple(w_gate.shape)}, {tuple(w_up.shape)}")
    _check(w_down.shape == (E, f, d), f"w_down shape {tuple(w_down.shape)}")
    _check(weights.shape == expert_ids.shape, "weights and expert_ids shapes differ")
    _check(expert_ids.dtype == torch.int32 and weights.dtype == torch.float32, "plan must be int32 ids, f32 weights")
    stacks = (w_gate, w_up, w_down)
    if scales is None:
        _check(all(w.dtype == x.dtype for w in stacks), "x and the expert stacks must share a dtype")
    else:
        _check(all(w.dtype == torch.int8 for w in stacks), "scales come with int8 expert stacks")
        _check(x.dtype in (torch.float32, torch.bfloat16), f"x must be f32 or bf16, got {x.dtype}")
        _check(len(scales) == 3 and all(s.dtype == torch.float32 and s.shape == (E,) for s in scales),
               f"scales must be three ({E},) f32 tensors")
    dev = x.device
    extra = () if scales is None else tuple(scales)
    _check(all(t.device == dev for t in (expert_ids, weights, *stacks, *extra)), "tensors on different devices")
    if dev.type == "cpu":
        return ref.decode_moe(x, expert_ids, weights, w_gate, w_up, w_down, scales)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    from repro_torch.kernels import check_launch, count_launch, dtype_code, function, ptr, stream_of

    _check(all(t.is_contiguous() for t in (x, expert_ids, weights, *stacks, *extra)), "tensors must be contiguous")
    fn = function(
        "moe_decode", "repro_decode_moe",
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )
    # one f32 scratch: the (T*k, f) h rows, then from the next 16-byte
    # boundary the (T*k, d) weighted down rows
    scratch = torch.empty(((T * k * f + 3) // 4 * 4 + T * k * d,), dtype=torch.float32, device=dev)
    out = torch.empty((T, d), dtype=torch.float32, device=dev)
    scale_ptrs = [ptr(s) for s in extra] or [ctypes.c_void_p(None)] * 3
    rc = fn(
        dtype_code(x.dtype), dtype_code(w_gate.dtype), ptr(x), ptr(expert_ids), ptr(weights), ptr(w_gate),
        ptr(w_up), ptr(w_down), *scale_ptrs, ptr(scratch), ptr(out), E, T, k, d, f, stream_of(x),
    )
    check_launch(rc, "decode_moe")
    count_launch(decode_moe_kernel, int8=scales is not None)
    return out


decode_moe_kernel.launches = 0
decode_moe_kernel.int8_launches = 0


def decode_moe(x: torch.Tensor, plan: DecodePlan, p) -> torch.Tensor:
    """Execute a (T_total, k) DecodePlan on layer params ``p``; (T, d) ->
    (T, d) in x's type.  When ``p`` carries the int8 twins (``w_gate_q``
    et al., :func:`repro_torch.models.moe.quantize_expert_stacks`) the
    launch reads them and their per-expert scale words; the full-precision
    stacks are left to prefill."""
    ids, w = plan.expert_ids.contiguous(), plan.weights.contiguous()
    if "w_gate_q" in p:
        scales = (p["w_gate_s"], p["w_up_s"], p["w_down_s"])
        y = decode_moe_kernel(x.contiguous(), ids, w, p["w_gate_q"], p["w_up_q"], p["w_down_q"], scales)
    else:
        y = decode_moe_kernel(x.contiguous(), ids, w, p["w_gate"], p["w_up"], p["w_down"])
    return y.to(x.dtype)
