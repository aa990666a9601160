"""Decoder stack for the ``moe`` and ``attn`` layer kinds (port of
``repro/models/transformer.py``, contiguous KV cache, chain speculation).

Layout: params are ``{"embed", "layers": [one dict per layer],
"final_norm", "unembed"}`` and the decode cache is a list with one dict per
layer — a Python loop over per-layer entries replaces the reference's
``lax.scan`` over stacked super-blocks.  The reference's ``_res`` barrier is
an identity at inference and is dropped.

The cache is updated IN PLACE: prefill and decode write their K/V rows and
DecodePlan rows into the preallocated cache tensors (the reference returns
a new cache from functional ``.at[].set`` updates).

Agile decode plane (``cfg.decode_plane``): each MoE layer's cache carries the
DecodePlan (``plan_e``/``plan_w``) the next launch consumes; prefill seeds it
from the prompt's last control-plane source, and every decode launch routes
the plan for the next one.  Attention reads only each token's valid cache
prefix (:mod:`repro_torch.kernels.flash_attention`), the expert FFN runs the
plan-steered kernel (:mod:`repro_torch.kernels.moe_decode`).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.control_plane import route_topk_decode
from repro_torch.core.plans import DecodePlan
from repro_torch.kernels.flash_attention import flash_decode
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.layers import Params

_KINDS = ("attn", "moe")


def _check_kind(kind: str, cfg: ModelConfig) -> None:
    if kind not in _KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is ported in a later slice")
    if cfg.attention_kind != "full" or cfg.paged or cfg.kv_dtype:
        raise NotImplementedError(
            "this slice serves full attention over a contiguous full-precision KV cache"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, kind: str, cfg: ModelConfig, device) -> Params:
    _check_kind(kind, cfg)
    d = cfg.d_model
    p: Params = {"ln1": L.init_rms_norm(d, device), "ln2": L.init_rms_norm(d, device)}
    p["attn"] = L.init_attention(gen, cfg, device)
    if kind == "moe":
        p["moe"] = moe.init_moe(gen, cfg, device)
    else:
        p["ffn"] = L.init_swiglu(gen, cfg, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Params:
    """Random weights with the reference's shapes and scales, drawn on
    ``device`` from ``generator`` (the numbers are not the reference's: the
    two frameworks' generators differ)."""
    params: Params = {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model, L.act_dtype(cfg), device),
        "layers": [init_layer(generator, kind, cfg, device) for kind in cfg.layer_kinds],
        "final_norm": L.init_rms_norm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_embedding(generator, cfg.vocab_size, cfg.d_model, torch.float32, device)
    return params


def init_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    """Contiguous KV stripes (B, max_len, nkv, hd) plus, for MoE layers on
    the decode plane, the carried DecodePlan: one row per draft position
    when ``spec_tokens > 1``."""
    _check_kind(kind, cfg)
    hd, dt = cfg.resolved_head_dim, L.act_dtype(cfg)
    c = {
        "k": torch.zeros((batch, max_len, cfg.num_kv_heads, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, max_len, cfg.num_kv_heads, hd), dtype=dt, device=device),
    }
    if kind == "moe" and cfg.decode_plane:
        Tp = max(int(cfg.spec_tokens), 1)
        shape = (batch, Tp, cfg.top_k) if Tp > 1 else (batch, cfg.top_k)
        c["plan_e"] = torch.zeros(shape, dtype=torch.int32, device=device)
        c["plan_w"] = torch.full(shape, 1.0 / cfg.top_k, dtype=torch.float32, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> List[Params]:
    return [init_layer_cache(kind, cfg, batch, max_len, device) for kind in cfg.layer_kinds]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _ffn(kind, cfg, p, h, ffn_in, route_src):
    """The layer's FFN on the prefill data plane; returns (y, next route_src)."""
    if kind == "moe":
        y, _ = moe.moe_layer(ffn_in, route_src, p["moe"], cfg)
        return y, h
    return L.swiglu(ffn_in, p["ffn"]), route_src


def apply_layer_prefill(
    x: torch.Tensor,                    # (B, S, d)
    route_src: Optional[torch.Tensor],
    p: Params,
    cache: Params,
    kind: str,
    cfg: ModelConfig,
    positions: torch.Tensor,            # (B, S)
    rows: slice,
):
    """Full-sequence pass that writes the prompt's K/V (and the seeded
    DecodePlan) into batch rows ``rows`` of ``cache``, in place.  The whole
    stripe is zeroed first, so the slot holds exactly what a fresh B=1 cache
    written into it would."""
    B, S, _ = x.shape
    if S > cache["k"].shape[1]:
        raise ValueError(f"prompt of {S} tokens exceeds the cache length {cache['k'].shape[1]}")
    xn = L.rms_norm(x, p["ln1"])
    q, k, v = L._qkv(xn, p["attn"], cfg, positions)
    for name, val in (("k", k), ("v", v)):
        stripe = cache[name][rows]
        stripe.zero_()
        stripe[:, :S] = val.to(stripe.dtype)
    out = L.blockwise_attention(q, k, v, causal=True)
    h = x + torch.einsum("bsnh,nhd->bsd", out, p["attn"]["wo"])
    ffn_in = L.rms_norm(h, p["ln2"])
    if kind == "moe" and cfg.decode_plane:
        # seed the first decode launch's plan from the prompt's last
        # control-plane source; every draft position starts from it
        src = (route_src if route_src is not None else h)[:, -1, :]
        seed = route_topk_decode(src, p["moe"]["router"], cfg.top_k)
        pe, pw = cache["plan_e"][rows], cache["plan_w"][rows]
        if pe.ndim == 3:
            pe.copy_(seed.expert_ids[:, None].expand_as(pe))
            pw.copy_(seed.weights[:, None].expand_as(pw))
        else:
            pe.copy_(seed.expert_ids)
            pw.copy_(seed.weights)
    y, route_src = _ffn(kind, cfg, p, h, ffn_in, route_src)
    return h + y, route_src


def _spec_positions(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B,) per-sequence lengths -> (B, T) absolute position per draft token."""
    return lengths[:, None].to(torch.int64) + torch.arange(T, dtype=torch.int64, device=lengths.device)[None, :]


def _decode_attn_prefix_spec(
    xn: torch.Tensor,       # (B, T, d)
    p: Params,
    cfg: ModelConfig,
    cache: Params,
    lengths: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """T-token attention over per-token valid prefixes [0, lengths[b] + t].

    The new K/V rows are written into the cache in place first; the
    per-token clamp then doubles as the intra-draft causal mask."""
    B, T, _ = xn.shape
    pos = _spec_positions(lengths, T)
    q, k, v = L._qkv(xn, p, cfg, pos)
    bidx = torch.arange(B, device=xn.device)[:, None]
    cache["k"][bidx, pos] = k.to(cache["k"].dtype)
    cache["v"][bidx, pos] = v.to(cache["v"].dtype)
    out = flash_decode(q, cache["k"], cache["v"], pos)  # (B, T, nq, hd)
    return torch.einsum("btnh,nhd->btd", out, p["wo"])


def apply_layer_decode_spec(
    x: torch.Tensor,             # (B, T, d): T chain tokens per sequence
    route_src: Optional[torch.Tensor],
    p: Params,
    cache: Params,
    kind: str,
    cfg: ModelConfig,
    lengths: torch.Tensor,       # (B,) per-sequence cache length
    prev_accept: torch.Tensor,   # (B,) accepted-row index into the plan vector
):
    """One layer of a speculative chain launch; updates ``cache`` in place.

    Plan semantics reproduce T sequential single-token steps: token 0
    consumes the cached plan row ``prev_accept`` selects, token t >= 1 the
    plan routed in this launch from position t-1's route source; all T routed
    plans are written back as the next launch's plan vector."""
    B, T, d = x.shape
    a = _decode_attn_prefix_spec(L.rms_norm(x, p["ln1"]), p["attn"], cfg, cache, lengths)
    h = x + a
    ffn_in = L.rms_norm(h, p["ln2"])
    if kind == "moe" and cfg.decode_plane:
        k_ = cfg.top_k
        src_seq = route_src if route_src is not None else h
        nxt = route_topk_decode(src_seq.reshape(B * T, d), p["moe"]["router"], k_)
        all_e = nxt.expert_ids.reshape(B, T, k_)
        all_w = nxt.weights.reshape(B, T, k_)
        cached_e, cached_w = cache["plan_e"], cache["plan_w"]
        if cached_e.ndim == 3:
            if cached_e.shape[1] != T:
                raise ValueError(f"cache carries {cached_e.shape[1]} plan rows but the launch has {T} tokens")
            ar = torch.arange(B, device=x.device)
            sel = prev_accept.to(device=x.device, dtype=torch.int64)
            first_e, first_w = cached_e[ar, sel], cached_w[ar, sel]
        else:
            first_e, first_w = cached_e.clone(), cached_w.clone()
        cons_e = torch.cat([first_e[:, None], all_e[:, : T - 1]], dim=1)
        cons_w = torch.cat([first_w[:, None], all_w[:, : T - 1]], dim=1)
        y = moe.moe_decode_ffn(ffn_in, DecodePlan(cons_e, cons_w), p["moe"])
        if cached_e.ndim == 3:
            cached_e.copy_(all_e)
            cached_w.copy_(all_w)
        else:
            cached_e.copy_(all_e[:, -1])
            cached_w.copy_(all_w[:, -1])
        route_src = h
    else:
        y, route_src = _ffn(kind, cfg, p, h, ffn_in, route_src)
    return h + y, route_src
