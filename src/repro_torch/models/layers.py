"""Shared layer math (port of ``repro/models/layers.py``): norms, RoPE, GQA
prefill attention, SwiGLU, embeddings, and the init functions with the
reference's shapes and scales.  Plain functions on tensors.

Weights are stored in the type each use computes in: the reference casts
them with ``.astype(x.dtype)`` at every use, so storing them already cast
computes the same thing (see :func:`storage_dtype`).  The uses still cast,
as the reference does: a no-op on the serving store, and the cast from the
f32 master weights that training keeps (``Model.init(train=True)``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig

Params = Dict[str, object]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# leaves the reference reads in f32 whatever the activation type: norm scales
# (cast to f32 inside rms_norm), the router (f32 control plane), unembed
# (logits are taken in f32), the RG-LRU's diagonal gates and the SSD block's
# decay, skip, step bias and gated-norm scale, which it keeps in f32 whatever
# the model's type (rglru.init_rec_block, mamba2.init_ssm_block)
_F32_LEAVES = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "router", "unembed",
               "alpha_r", "b_r", "alpha_i", "b_i", "lam", "A_log", "D", "dt_bias", "norm_scale")


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# the int8 twins of the routed expert stacks and their per-expert f32 scale
# words (moe.quantize_expert_stacks), stored as the reference makes them
_EXPERT_STACKS = ("w_gate", "w_up", "w_down")
_INT8_LEAVES = tuple(n + "_q" for n in _EXPERT_STACKS)
_SCALE_LEAVES = tuple(n + "_s" for n in _EXPERT_STACKS)


def storage_dtype(cfg: ModelConfig, leaf: str) -> torch.dtype:
    """The type a parameter leaf is stored in (its last path component)."""
    if leaf in _INT8_LEAVES:
        return torch.int8
    return torch.float32 if leaf in _F32_LEAVES or leaf in _SCALE_LEAVES else act_dtype(cfg)


# ---------------------------------------------------------------------------
# init helpers (same shapes and scales as the reference; other numbers)
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std^2) drawn in ``dtype`` on ``device`` from ``gen``."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)


def dense_init(gen, in_dim: int, out_shape, dtype, device, scale: Optional[float] = None) -> torch.Tensor:
    """Fan-in scaled normal init; out_shape may be a tuple (multi-head)."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return normal(gen, (in_dim, *out_shape), std, dtype, device)


def init_rms_norm(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)  # (1 + scale)


def init_attention(gen, cfg: ModelConfig, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dt = act_dtype(cfg)
    p: Params = {
        "wq": dense_init(gen, d, (nq, hd), dt, device),
        "wk": dense_init(gen, d, (nkv, hd), dt, device),
        "wv": dense_init(gen, d, (nkv, hd), dt, device),
        "wo": dense_init(
            gen, nq * hd, d, dt, device, scale=1.0 / math.sqrt(nq * hd * 2 * cfg.num_layers)
        ).reshape(nq, hd, d),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((n, hd), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, device)
        p["k_norm"] = init_rms_norm(hd, device)
    return p


def init_swiglu(gen, cfg: ModelConfig, device) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, act_dtype(cfg)
    return {
        "w_gate": dense_init(gen, d, f, dt, device),
        "w_up": dense_init(gen, d, f, dt, device),
        "w_down": dense_init(gen, f, d, dt, device, scale=1.0 / math.sqrt(f * 2 * cfg.num_layers)),
    }


def init_embedding(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms, RoPE
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))).to(x.dtype)


@functools.lru_cache(maxsize=16)
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """The (head_dim / 2,) f32 rotary frequencies, made once per (head_dim,
    theta, device): building them copies ``theta`` from the host, which on
    the card is a synchronous copy (twice a layer of every launch, and
    illegal inside a CUDA graph's capture).  Callers must not write to the
    shared tensor."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = (positions[..., None].to(torch.float32) * freqs)[..., None, :]  # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _qkv(x: torch.Tensor, p: Params, cfg: ModelConfig, positions: torch.Tensor):
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q, k, v = q + p["bq"].to(x.dtype), k + p["bk"].to(x.dtype), v + p["bv"].to(x.dtype)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, nq, hd)
    k: torch.Tensor,  # (B, Skv, nkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    local_window: int = 0,
    block_kv: int = 1024,
) -> torch.Tensor:
    """Flash-style online-softmax attention over KV blocks, in f32; with
    ``local_window`` query i sees only keys j with ``i - j < local_window``.

    The reference computes this in jnp, and it is the oracle of its Pallas
    flash-attention kernel; here it is the plain version of the prefill
    kernel (``kernels/flash_attention``), which the model calls: matmuls and
    an explicit online softmax over blocks.  GQA heads are expanded by
    repetition (the reference's one-hot einsum multiplies by exactly 1, so
    the two agree bit for bit).
    """
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    if nq // nkv > 1:
        k = k.repeat_interleave(nq // nkv, dim=2)
        v = v.repeat_interleave(nq // nkv, dim=2)
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(torch.float32).permute(0, 2, 1, 3)  # (B, nq, Sq, hd)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, nq, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, nq, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nq, Sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, Skv, block_kv):
        kb, vb = kf[:, :, start:start + block_kv], vf[:, :, start:start + block_kv]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        kv_pos = start + torch.arange(kb.shape[2], device=q.device)
        if causal:
            s = s.masked_fill(~(q_pos[:, None] >= kv_pos[None, :]), NEG_INF)
        if local_window:
            s = s.masked_fill(~(q_pos[:, None] - kv_pos[None, :] < local_window), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention_block_train(x: torch.Tensor, p: Params, cfg: ModelConfig, *, positions: torch.Tensor,
                          local_window: int = 0) -> torch.Tensor:
    """The training attention sub-block (the reference's ``attention_block``
    without a cache): :func:`_qkv`, kernel 7 with its backward
    (``flash_attention_train``), then ``wo`` cast to the activations' type."""
    from repro_torch.kernels.flash_attention import flash_attention_train

    q, k, v = _qkv(x, p, cfg, positions)
    out = flash_attention_train(q, k, v, causal=True, window=local_window)
    return torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(out.dtype))


# ---------------------------------------------------------------------------
# FFN, embeddings
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, p: Params) -> torch.Tensor:
    """SwiGLU over the last axis of x (tokens (..., d) -> (..., d))."""
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (torch.nn.functional.silu(g) * u) @ p["w_down"].to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor, dtype) -> torch.Tensor:
    return table.to(dtype)[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in f32.  ``table`` is stored in f32 (the untied table, or the
    tied embedding's f32 copy), so its cast is a no-op."""
    return torch.einsum("bsd,vd->bsv", x.to(torch.float32), table.to(torch.float32))
