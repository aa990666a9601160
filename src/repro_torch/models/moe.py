"""MoE FFN with control-flow-plane routing (port of ``repro/models/moe.py``).

* ``dense``     — predication baseline: all experts on all tokens,
                  probability-masked combine.
* ``sync``      — the router runs inline on the FFN input.
* ``lookahead`` — the plan is computed from the previous layer's residual
                  stream (``route_src``) and arrives as an input.

The prefill data plane is the fused pair of kernels
(:mod:`repro_torch.kernels.moe_fused`) for every token count, under
autograd with its hand-written backward when training (the plan's combine
weights carry the gradient into the router); the decode data
plane executes the cache-carried DecodePlan
(:mod:`repro_torch.kernels.moe_decode`), over the int8 twins of the stacks
under ``cfg.expert_dtype == "int8"`` (:func:`quantize_expert_stacks`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.control_plane import RouterAux, _top_k, capacity_for, route_topk
from repro_torch.core.plans import DecodePlan, DispatchPlan
from repro_torch.core.quant import quantize_int8
from repro_torch.kernels.moe_decode import decode_moe
from repro_torch.kernels.moe_fused import fused_moe_fn
from repro_torch.models.layers import Params, act_dtype, normal, swiglu

# The reference caps its fused plane at a (T+1, d) f32 block of 8 MB
# (``_FUSED_VMEM_BYTES``): its kernels keep the whole token block and the
# combine accumulator in the TPU's on-chip VMEM.  The CUDA kernels gather x
# rows tile by tile and add into the output in device memory, so nothing
# bounds T here and the fused pair is the prefill data plane for every T.


def init_moe(gen: torch.Generator, cfg: ModelConfig, device, experts: Optional[slice] = None) -> Params:
    """``experts``: keep only that slice of each expert stack, cut as soon
    as the stack is drawn (the weights are those of the whole draw)."""
    d, E = cfg.d_model, cfg.num_experts
    f = cfg.d_ff_expert or cfg.d_ff
    dt = act_dtype(cfg)
    down_std = 1.0 / math.sqrt(f * 2 * cfg.num_layers)

    def stack(shape, std):
        w = normal(gen, shape, std, dt, device)
        return w if experts is None else w[experts].clone()

    p: Params = {
        "router": normal(gen, (d, E), 0.02, torch.float32, device),  # control plane: f32
        "w_gate": stack((E, d, f), 1.0 / math.sqrt(d)),
        "w_up": stack((E, d, f), 1.0 / math.sqrt(d)),
        "w_down": stack((E, f, d), down_std),
    }
    if cfg.num_shared_experts:
        sh = cfg.num_shared_experts * f
        p["shared"] = {
            "w_gate": normal(gen, (d, sh), 1.0 / math.sqrt(d), dt, device),
            "w_up": normal(gen, (d, sh), 1.0 / math.sqrt(d), dt, device),
            "w_down": normal(gen, (sh, d), down_std, dt, device),
        }
    if cfg.expert_dtype not in ("", "int8"):
        raise ValueError(f"expert_dtype must be '' or 'int8', got {cfg.expert_dtype!r}")
    if cfg.expert_dtype == "int8":
        p.update(quantize_expert_stacks(p))
    return p


def quantize_expert_stacks(p: Params) -> Params:
    """int8 twins of the routed expert stacks for the decode data plane:
    ``w_gate_q`` et al. with per-expert f32 scale words ``w_gate_s`` (E,),
    which kernel 2 reads next to the plan's expert ids.  Each stack is
    quantized over axes (1, 2) from its f32 cast.  The full-precision stacks
    stay: prefill never reads int8; the plan-steered decode launches (and so
    speculative verify) do (:func:`repro_torch.kernels.moe_decode.decode_moe`).
    Cut to a rank's expert slice, the twins are the slice of the whole
    stack's (the scales are per expert)."""
    out: Params = {}
    for name in ("w_gate", "w_up", "w_down"):
        q, s = quantize_int8(p[name].to(torch.float32), axis=(1, 2))
        out[name + "_q"] = q
        out[name + "_s"] = s[:, 0, 0].to(torch.float32)
    return out


def _shared_experts(xf: torch.Tensor, p: Params) -> torch.Tensor:
    """Always-on shared-expert SwiGLU over flat tokens (T, d) -> (T, d)."""
    return swiglu(xf, p["shared"])


def _zero_aux(device) -> RouterAux:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return RouterAux(z, z, z)


def moe_ffn(
    x: torch.Tensor,  # (B, S, d)
    p: Params,
    cfg: ModelConfig,
    *,
    plan: Optional[DispatchPlan] = None,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, RouterAux]:
    """Apply the MoE FFN; with ``plan`` (lookahead mode) the router does not
    run here.  Differentiable on every path (the fused pair through its
    backward kernels, :func:`fused_moe_fn`)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    T = B * S
    if cfg.route_mode == "dense" and plan is None:
        logits = xf.to(torch.float32) @ p["router"]
        probs = torch.softmax(logits, dim=-1)
        top_w, top_e = _top_k(probs, cfg.top_k)
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
        mask = torch.zeros_like(probs).scatter(1, top_e, top_w)
        g = torch.einsum("td,edf->etf", xf, p["w_gate"].to(xf.dtype))
        u = torch.einsum("td,edf->etf", xf, p["w_up"].to(xf.dtype))
        y_all = torch.einsum("etf,efd->etd", torch.nn.functional.silu(g) * u, p["w_down"].to(xf.dtype))
        y = torch.einsum("etd,te->td", y_all.to(torch.float32), mask).to(x.dtype)
        z = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = RouterAux(z, torch.mean(torch.logsumexp(logits, dim=-1) ** 2), z)
    else:
        if plan is None:  # sync mode: route inline
            C = capacity if capacity is not None else capacity_for(T, cfg.num_experts, cfg.top_k, cfg.capacity_factor)
            plan, aux = route_topk(xf, p["router"], cfg.top_k, C)
        else:
            aux = _zero_aux(x.device)
        y = fused_moe_fn(xf, plan, p).to(x.dtype)
    if "shared" in p:
        y = y + _shared_experts(xf, p)
    return y.reshape(B, S, d), aux


def moe_layer(
    x_ffn: torch.Tensor,  # (B, S, d) normalized FFN input
    route_src: Optional[torch.Tensor],  # (B, S, d) control-plane routing source
    p: Params,
    cfg: ModelConfig,
    *,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, RouterAux]:
    """Mode-dispatching MoE layer (lookahead routes from ``route_src``)."""
    B, S, d = x_ffn.shape
    T = B * S
    if cfg.route_mode == "dense":
        return moe_ffn(x_ffn, p, cfg)
    C = capacity if capacity is not None else capacity_for(T, cfg.num_experts, cfg.top_k, cfg.capacity_factor)
    src = x_ffn if (cfg.route_mode == "sync" or route_src is None) else route_src
    plan, aux = route_topk(src.reshape(T, d), p["router"], cfg.top_k, C)
    y, _ = moe_ffn(x_ffn, p, cfg, plan=plan)
    return y, aux


def moe_decode_ffn(x: torch.Tensor, plan: DecodePlan, p: Params) -> torch.Tensor:
    """Execute a cache-carried DecodePlan on the decode data plane:
    (B, S, d) -> (B, S, d); the router does not run here."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    y = decode_moe(xf, plan.flatten(), p)
    if "shared" in p:
        y = y + _shared_experts(xf, p)
    return y.reshape(B, S, d)
