"""Mamba-2 SSD block (port of ``repro/models/mamba2.py``; state-space
duality, arXiv:2405.21060).

Per head h with state size N and head dim P:

    h_t = exp(dt_t * a_h) * h_{t-1} + dt_t * B_t (x) x_t      (N x P state)
    y_t = C_t^T h_t + D_h * x_t

Prefill and training run the chunked SSD algorithm through the ``ssd_scan``
kernel (:mod:`repro_torch.kernels.ssd_scan`; its plain version, the
reference's ``ssd_chunked``, on the CPU) under autograd, with kernel 11's
backward when training (:func:`ssm_block` is also the training pass).  The
reference model calls the jnp ``ssd_chunked`` here and differentiates it;
the port calls the kernel, as it wires the prefill attention and RG-LRU
kernels into their blocks.  Decode is one recurrent
step in plain tensor ops carrying ``(h, conv tail)``; the reference has no
decode kernel either.  ``A_log``, ``D``, ``dt_bias``, ``norm_scale``, the
step sizes and the state are f32 whatever the model's type.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import Params, act_dtype, dense_init, normal, rms_norm
from repro_torch.models.rglru import causal_conv1d


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim, state size)."""
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    return d_in, d_in // P, P, cfg.ssm_state


def init_ssm_block(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, dt = cfg.d_model, act_dtype(cfg)
    d_in, H, P, N = dims(cfg)
    f32 = torch.float32
    proj_out = 2 * d_in + 2 * N + H  # z, x, B, C, dt
    conv_ch = d_in + 2 * N
    K = cfg.conv1d_width
    return {
        "w_in": dense_init(gen, d, proj_out, dt, device),
        "conv_w": normal(gen, (K, conv_ch), 1.0 / math.sqrt(K), dt, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32, device=device)),
        "D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, H, dtype=f32, device=device))),
        "norm_scale": torch.zeros((d_in,), dtype=f32, device=device),
        "w_out": dense_init(gen, d_in, d, dt, device, scale=1.0 / math.sqrt(d_in * 2 * cfg.num_layers)),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """(z, x, B, C, dt) views of the input projection, in that order."""
    d_in, H, P, N = dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)


def _xbc(zxbcdt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The conv's channels: x, B and C, adjacent in the projection (a view)."""
    d_in, H, P, N = dims(cfg)
    return zxbcdt[..., d_in:2 * d_in + 2 * N]


def _gated_out(y: torch.Tensor, z: torch.Tensor, p: Params) -> torch.Tensor:
    return rms_norm(y * F.silu(z), p["norm_scale"]) @ p["w_out"].to(y.dtype)


def ssm_block(
    x: torch.Tensor,  # (B, T, d)
    p: Params,
    cfg: ModelConfig,
    h0: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """The prompt's pass (B, T, d) -> y (B, T, d), and with ``return_state``
    the final state ``{"h": (B, H, N, P) f32, "conv": (B, K-1, ch)}``; also
    the training pass (reference ``ssm_block`` without state): every weight
    cast to x's type at use (a no-op when serving), the scan differentiable
    (:func:`~repro_torch.kernels.ssd_scan.ops.ssd_scan_train`).  The conv
    tail holds the last K-1 pre-activation conv inputs, zeros before the
    prompt's start (the causal pad), so a prompt shorter than K-1 also
    continues exactly (the reference keeps fewer rows)."""
    d_in, H, P, N = dims(cfg)
    Bsz, T, _ = x.shape
    zxbcdt = x @ p["w_in"].to(x.dtype)
    z, _, _, _, dt_raw = _split_proj(zxbcdt, cfg)
    raw = _xbc(zxbcdt, cfg)
    xbc = F.silu(causal_conv1d(raw, p["conv_w"], p["conv_b"]))
    xs, bm, cm = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (B, T, H)
    a = -torch.exp(p["A_log"])
    xh = xs.reshape(Bsz, T, H, P)
    y, h_final = ssd_ops.ssd_scan_train(xh, dt, a, bm, cm, cfg.ssm_chunk, h0=h0)
    y = y + p["D"][None, None, :, None] * xh.to(torch.float32)
    out = _gated_out(y.reshape(Bsz, T, d_in).to(x.dtype), z, p)
    if not return_state:
        return out
    K = p["conv_w"].shape[0]
    tail = F.pad(raw, (0, 0, max(K - 1 - T, 0), 0))
    return out, {"h": h_final, "conv": tail[:, tail.shape[1] - (K - 1):]}


def init_ssm_state(batch: int, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """``h`` (B, H, N, P) f32 and the conv tail ``conv`` (B, K-1, d_inner + 2N)
    in the model's type."""
    d_in, H, P, N = dims(cfg)
    return {
        "h": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, d_in + 2 * N), dtype=act_dtype(cfg), device=device),
    }


def ssm_block_decode(
    x: torch.Tensor,  # (B, 1, d)
    p: Params,
    cfg: ModelConfig,
    state: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """One decode step; updates ``state`` (``h``, ``conv``) in place and
    returns y (B, 1, d)."""
    d_in, H, P, N = dims(cfg)
    zxbcdt = x[:, 0] @ p["w_in"]
    z, _, _, _, dt_raw = _split_proj(zxbcdt, cfg)
    window = torch.cat([state["conv"], _xbc(zxbcdt, cfg)[:, None].to(state["conv"].dtype)], dim=1)  # (B, K, ch)
    conv = (window * p["conv_w"].to(window.dtype)[None]).sum(dim=1) + p["conv_b"].to(window.dtype)
    xs, bm, cm = torch.split(F.silu(conv), [d_in, N, N], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (B, H)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))
    xh = xs.reshape(-1, H, P).to(torch.float32)
    h = state["h"]
    h.mul_(decay[:, :, None, None]).add_(bm.to(torch.float32)[:, None, :, None] * (dt[:, :, None] * xh)[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", cm.to(torch.float32), h) + p["D"][None, :, None] * xh
    state["conv"].copy_(window[:, 1:])
    return _gated_out(y.reshape(-1, d_in).to(x.dtype), z, p)[:, None]
