"""RG-LRU recurrent block (port of ``repro/models/rglru.py``; Griffin /
RecurrentGemma, arXiv:2402.19427).

Block:  y = W_out( RG-LRU(conv1d(W_x x)) * gelu(W_gate x) )

RG-LRU (per channel, diagonal gates, as in the reference):

    r_t = sigmoid(alpha_r * u_t + b_r)            recurrence gate
    i_t = sigmoid(alpha_i * u_t + b_i)            input gate
    log a_t = -c * softplus(lam) * r_t            c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Prefill runs the recurrence through the ``rglru_scan`` kernel
(:mod:`repro_torch.kernels.rglru_scan`; the plain version :func:`linear_scan`
on the CPU) under autograd, with its reversed instantiation as the backward
when training (:func:`rec_block_prefill` is also the training pass); decode
is a single step carrying ``(h, conv tail)``.  The gates
and the state ``h`` are f32 whatever the model's type; ``gelu`` is the tanh
approximation (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import linear_scan  # noqa: F401  (the plain scan, the reference's name)
from repro_torch.models.layers import Params, act_dtype, dense_init, normal

_C = 8.0  # Griffin's gate sharpness constant


def init_rec_block(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, w, dt = cfg.d_model, cfg.lru_width, act_dtype(cfg)
    f32 = torch.float32
    # lam so that a^c lies in [0.9, 0.999] at r = 1 (Griffin's init range)
    lin = torch.linspace(0.9, 0.999, w, dtype=f32, device=device)
    return {
        "w_x": dense_init(gen, d, w, dt, device),
        "w_gate": dense_init(gen, d, w, dt, device),
        "conv_w": normal(gen, (cfg.conv1d_width, w), 1.0 / math.sqrt(cfg.conv1d_width), dt, device),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "alpha_r": torch.ones((w,), dtype=f32, device=device),
        "b_r": torch.zeros((w,), dtype=f32, device=device),
        "alpha_i": torch.ones((w,), dtype=f32, device=device),
        "b_i": torch.zeros((w,), dtype=f32, device=device),
        "lam": torch.log(torch.expm1(-torch.log(lin) / _C)),
        "w_out": dense_init(gen, w, d, dt, device, scale=1.0 / math.sqrt(w * 2 * cfg.num_layers)),
    }


def causal_conv1d(u: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time.  u: (B, T, W); conv_w: (K, W)."""
    K, T = conv_w.shape[0], u.shape[1]
    pad = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros_like(u)
    for i in range(K):  # the reference's tap order
        out = out + pad[:, i:i + T, :] * conv_w[i].to(u.dtype)
    return out + conv_b.to(u.dtype)


def rg_lru_gates(u: torch.Tensor, p: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_t, gated input) in f32.  u: (..., W)."""
    uf = u.to(torch.float32)
    r = torch.sigmoid(uf * p["alpha_r"] + p["b_r"])
    i = torch.sigmoid(uf * p["alpha_i"] + p["b_i"])
    log_a = -_C * torch.nn.functional.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    return a, b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def init_rec_state(batch: int, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """``h`` (B, W) f32 and the conv tail ``conv`` (B, K-1, W) in the model's type."""
    return {
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, cfg.lru_width), dtype=act_dtype(cfg), device=device),
    }


def rec_block_prefill(x: torch.Tensor, p: Params, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The prompt's pass (B, T, d) -> (y (B, T, d), final state), also the
    training pass (its ``y``; reference ``rec_block``): every weight cast
    to x's type at use (a no-op when serving), the scan differentiable
    (:func:`~repro_torch.kernels.rglru_scan.ops.rglru_scan_train`).  The
    conv tail holds the last K-1 inputs of the conv, zeros before the
    prompt's start (the causal pad), so a prompt shorter than K-1 also
    continues exactly."""
    u = torch.einsum("btd,dw->btw", x, p["w_x"].to(x.dtype))
    u_conv = causal_conv1d(u, p["conv_w"], p["conv_b"])
    a, b = rg_lru_gates(u_conv, p)
    h_all = scan_ops.rglru_scan_train(a, b)  # (B, T, W) f32
    gate = _gelu(torch.einsum("btd,dw->btw", x, p["w_gate"].to(x.dtype)))
    y = torch.einsum("btw,wd->btd", h_all.to(x.dtype) * gate, p["w_out"].to(x.dtype))
    K = p["conv_w"].shape[0]
    up = torch.nn.functional.pad(u, (0, 0, max(K - 1 - u.shape[1], 0), 0))
    return y, {"h": h_all[:, -1], "conv": up[:, up.shape[1] - (K - 1):]}


def rec_block_decode(
    x: torch.Tensor,  # (B, 1, d)
    p: Params,
    cfg: ModelConfig,
    state: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """One decode step; updates ``state`` (``h``, ``conv``) in place and
    returns y (B, 1, d)."""
    u = torch.einsum("btd,dw->btw", x, p["w_x"])[:, 0]  # (B, W)
    window = torch.cat([state["conv"], u[:, None].to(state["conv"].dtype)], dim=1)  # (B, K, W)
    u_conv = (window * p["conv_w"].to(u.dtype)[None]).sum(dim=1) + p["conv_b"].to(u.dtype)
    a, b = rg_lru_gates(u_conv, p)
    h = a * state["h"] + b
    gate = _gelu(torch.einsum("btd,dw->btw", x, p["w_gate"])[:, 0])
    y = torch.einsum("bw,wd->bd", h.to(x.dtype) * gate, p["w_out"])
    state["h"].copy_(h)
    state["conv"].copy_(window[:, 1:])
    return y[:, None]
