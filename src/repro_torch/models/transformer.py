"""Decoder stack for the ``moe``, ``attn``, ``local``, ``rec`` and ``ssm`` layer kinds
(port of ``repro/models/transformer.py``: contiguous, paged and
rolling-window KV caches, RG-LRU and SSD state, chain and tree
speculation).

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

Local attention (a ``local`` layer, or every attention layer under
``cfg.attention_kind == "local"``; :func:`window_of` decides per layer, so
one stack may mix full and windowed layers): the layer keeps a rolling
buffer of ``min(max_len, window + spec slack)`` rows, the token at
position ``pos`` in slot ``pos % W`` (:func:`rolling_rows`);
prefill attends through the window mask and decode through the
window-steered flash-decode kernel, so KV memory is bounded by the window
whatever the prompt's length.  Rolling buffers stay unpaged under
``cfg.paged`` (their bound is the window, not ``max_len``): chains decode
through the window kernel, branchy draft trees through the
ancestor-masked plain attention :func:`_decode_attn_rolling_tree`, whose
accepted path moves arrive as the next launch's commit maps, mod W.
``rec`` layers (RG-LRU,
:mod:`repro_torch.models.rglru`) and ``ssm`` layers (Mamba-2 SSD,
:mod:`repro_torch.models.mamba2`; a single pre-norm and no FFN) carry
``h``/``conv`` state instead of K/V and decode one token per launch (they
pass through the paged plane untouched).

Modality frontends (``cfg.frontend``, the reference's vision and audio
stubs): ``params["frontend"]["proj"]`` (frontend_dim, d_model) projects
precomputed frontend embeddings onto the first ``frontend_tokens``
positions of the prompt (:meth:`repro_torch.models.model.Model._embed`).

Paged KV plane (``cfg.paged``): the full-attention KV lives in a flat pool
``pk``/``pv`` of ``num_pages * page_size`` rows with no batch axis, addressed
through the per-slot block table each launch takes.  The pool carries ONE
trash row past its last page: writes the reference drops
(``.at[].set(mode="drop")`` at row ``R``) land there instead, so no host
sync filters them and no out-of-range index reaches the card.

Quantized bandwidth plane (``cfg.kv_dtype == "int8"``): K/V rows are stored
int8 with one f32 scale per token row (``ks``/``vs`` (B, S), paged
``pks``/``pvs`` (R + 1,), initialized to ones), quantized over (nkv, hd)
as each row is written, at admission and at every decode write.  Prefill
attention runs on the full-precision rows; decode attention reads the int8
rows and their scales (the kernels' int8 branch).  Every cache mutation
(commit, CoW, paged admission) moves an (int8 row, scale) pair together.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.control_plane import route_topk_decode, topk_agreement
from repro_torch.core.plans import DecodePlan, TreePlan
from repro_torch.core.quant import quantize_int8
from repro_torch.kernels.flash_attention import flash_attention, flash_decode, flash_decode_paged, flash_decode_window
from repro_torch.kernels.flash_attention.ref import dequantize_rows
from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe, rglru
from repro_torch.models.layers import Params

# moe_apply(x_ffn (B, S, d), route_src, p) -> (y (B, S, d), aux): the
# prefill data plane of an MoE layer; decode_apply(x_ffn, plan, p) -> y
# executes a cache-carried DecodePlan.  Injectable so the distributed
# runtime can bind the expert-parallel applies
# (repro_torch.parallel.moe_parallel); the single-host defaults are
# moe.moe_layer and moe.moe_decode_ffn.
MoeApply = Callable[[torch.Tensor, Optional[torch.Tensor], Params], Tuple[torch.Tensor, Any]]
DecodeApply = Callable[[torch.Tensor, DecodePlan, Params], torch.Tensor]

_KINDS = ("attn", "local", "moe", "rec", "ssm")
# the paged pool's leaves: int8-or-not payload rows, then (int8) their scales
POOL_LEAVES = ("pk", "pv", "pks", "pvs")
# the contiguous (or rolling) cache's leaves, in the same order
KV_LEAVES = ("k", "v", "ks", "vs")
# layers whose decode state is a recurrence, not KV rows: they bound no
# position and advance one token per launch
STATE_KINDS = ("rec", "ssm")


def window_of(cfg: ModelConfig, kind: str) -> int:
    """The local window of an attention layer of ``kind`` (0 = full
    attention): ``cfg.local_window`` for a ``local`` layer and, under
    ``cfg.attention_kind == "local"``, for every attention layer (the
    reference's per-layer rule)."""
    return cfg.local_window if kind == "local" or cfg.attention_kind == "local" else 0


def has_full_attention(cfg: ModelConfig) -> bool:
    """Whether some layer keeps a full-length KV cache (an ``attn`` or
    ``moe`` layer outside local attention): the layers the paged plane
    pools and whose rows bound a position."""
    return any(k not in STATE_KINDS and not window_of(cfg, k) for k in cfg.layer_kinds)


def _check_kind(kind: str, cfg: ModelConfig) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown layer kind {kind!r}; known: {_KINDS}")
    if cfg.attention_kind not in ("full", "local"):
        raise NotImplementedError("this slice serves full and local attention")
    if cfg.kv_dtype not in ("", "int8"):
        raise ValueError(f"kv_dtype must be '' or 'int8', got {cfg.kv_dtype!r}")
    if kind not in STATE_KINDS and (kind == "local" or cfg.attention_kind == "local") and cfg.local_window <= 0:
        raise ValueError("local attention needs local_window > 0")


def check_spec_width(cfg: ModelConfig, T: int) -> None:
    """Stateful recurrences advance one token per launch: ``rec`` and
    ``ssm`` layers serve spec width 1 only (the reference's refusal, word
    for word, naming the first such layer's kind)."""
    kinds = [k for k in cfg.layer_kinds if k in STATE_KINDS]
    if T != 1 and kinds:
        raise NotImplementedError(
            f"multi-token decode for {kinds[0]!r} layers needs a T-step state "
            "recurrence; serve rec/ssm archs with spec_tokens=1"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, kind: str, cfg: ModelConfig, device,
               experts: Optional[slice] = None) -> Params:
    _check_kind(kind, cfg)
    d = cfg.d_model
    p: Params = {"ln1": L.init_rms_norm(d, device)}
    if kind == "ssm":  # a single pre-norm, no FFN
        p["ssm"] = mamba2.init_ssm_block(gen, cfg, device)
        return p
    p["ln2"] = L.init_rms_norm(d, device)
    if kind == "rec":
        p["rec"] = rglru.init_rec_block(gen, cfg, device)
    else:
        p["attn"] = L.init_attention(gen, cfg, device)
    if kind == "moe":
        p["moe"] = moe.init_moe(gen, cfg, device, experts)
    else:
        p["ffn"] = L.init_swiglu(gen, cfg, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device, experts: Optional[slice] = None, *,
                train: bool = False) -> Params:
    """Random weights with the reference's shapes and scales, drawn on
    ``device`` from ``generator`` (the numbers are not the reference's: the
    two frameworks' generators differ).  ``experts`` keeps that slice of
    every expert stack, cut layer by layer as it is drawn.  With ``train``
    every leaf is drawn in ``cfg.param_dtype`` (the reference's f32 master
    weights, cast where each is used) and tied embeddings keep no
    ``unembed`` copy: the logits read ``embed`` itself, so both uses train
    the one table."""
    if train:
        cfg = dataclasses.replace(cfg, dtype=cfg.param_dtype)
    params: Params = {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model, L.act_dtype(cfg), device),
        "layers": [init_layer(generator, kind, cfg, device, experts) for kind in cfg.layer_kinds],
        "final_norm": L.init_rms_norm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_embedding(generator, cfg.vocab_size, cfg.d_model, torch.float32, device)
    if cfg.frontend:
        params["frontend"] = {"proj": L.dense_init(generator, cfg.frontend_dim, cfg.d_model, L.act_dtype(cfg), device)}
    return params if train else place_tied_unembed(params, cfg)


def place_tied_unembed(params: Params, cfg: ModelConfig) -> Params:
    """With tied embeddings the logits read the embedding table in f32: keep
    one f32 copy of it as ``params["unembed"]``, made once when the weights
    are placed (an f32 table is shared, not copied), instead of casting the
    whole table at every launch.  Returns ``params``."""
    if cfg.tie_embeddings:
        params["unembed"] = params["embed"].to(torch.float32)
    return params


def max_pages_for(cfg: ModelConfig, max_len: int) -> int:
    """Block-table width: logical pages covering one slot's max_len."""
    return -(-int(max_len) // int(cfg.page_size))


def num_pages(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Default physical pool size: the contiguous capacity, in pages."""
    return batch * max_pages_for(cfg, max_len)


def identity_page_table(cfg: ModelConfig, batch: int, max_len: int) -> torch.Tensor:
    """The (B, max_pages) block table reproducing the contiguous layout:
    slot b's logical page i is physical page ``b * max_pages + i``.  With it
    the paged chain path is bitwise the contiguous path."""
    mp = max_pages_for(cfg, max_len)
    return torch.arange(batch, dtype=torch.int32)[:, None] * mp + torch.arange(mp, dtype=torch.int32)[None, :]


def rolling_rows(cfg: ModelConfig, max_len: int, kind: str) -> int:
    """Rows of the contiguous cache of an attention layer of ``kind``:
    ``max_len``, or for a local layer ``min(max_len, window + slack)``
    (:func:`window_of`).  The slack is
    ``spec_tokens - 1`` rounded up to 8: a launch writes all T tokens before
    attending, and with exactly ``window`` slots the later tokens would
    evict positions still inside the earlier tokens' windows."""
    window = window_of(cfg, kind)
    if not window:
        return max_len
    slack = -(-(max(int(cfg.spec_tokens), 1) - 1) // 8) * 8
    return min(max_len, window + slack)


def init_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int, device,
                     pool_batch: Optional[int] = None) -> Params:
    """``rec`` layers: the RG-LRU state (``h`` (B, W) f32, ``conv``);
    ``ssm`` layers: the SSD state (``h`` (B, H, N, P) f32, ``conv``).
    Attention layers: contiguous KV stripes (B, S, nkv, hd) with
    ``S = rolling_rows(cfg, max_len, kind)`` (a rolling buffer for a local
    layer, paged or not), or under ``cfg.paged`` for full attention the
    flat pool (num_pages * page_size + 1 trash row, nkv, hd), plus, for MoE layers on the decode plane, the
    carried DecodePlan: one row per draft position when ``spec_tokens > 1``
    (per slot, paged or not).  Under ``cfg.kv_dtype == "int8"`` the K/V
    rows are int8 and each row has an f32 scale, ``ks``/``vs`` (B, S) or
    ``pks``/``pvs`` (rows,), all ones at first.  ``pool_batch`` (default
    ``batch``) sizes the pool: a data-parallel rank keeps its own slots'
    rows and the whole pool."""
    _check_kind(kind, cfg)
    if kind == "rec":
        return rglru.init_rec_state(batch, cfg, device)
    if kind == "ssm":
        return mamba2.init_ssm_state(batch, cfg, device)
    hd = cfg.resolved_head_dim
    quant = cfg.kv_dtype == "int8"
    dt = torch.int8 if quant else L.act_dtype(cfg)
    if cfg.paged and not window_of(cfg, kind):
        rows = num_pages(cfg, pool_batch or batch, max_len) * cfg.page_size + 1
        c = {
            "pk": torch.zeros((rows, cfg.num_kv_heads, hd), dtype=dt, device=device),
            "pv": torch.zeros((rows, cfg.num_kv_heads, hd), dtype=dt, device=device),
        }
        if quant:
            c["pks"] = torch.ones((rows,), dtype=torch.float32, device=device)
            c["pvs"] = torch.ones((rows,), dtype=torch.float32, device=device)
    else:
        S = rolling_rows(cfg, max_len, kind)
        c = {
            "k": torch.zeros((batch, S, cfg.num_kv_heads, hd), dtype=dt, device=device),
            "v": torch.zeros((batch, S, cfg.num_kv_heads, hd), dtype=dt, device=device),
        }
        if quant:
            c["ks"] = torch.ones((batch, S), dtype=torch.float32, device=device)
            c["vs"] = torch.ones((batch, S), dtype=torch.float32, device=device)
    if kind == "moe" and cfg.decode_plane:
        Tp = max(int(cfg.spec_tokens), 1)
        shape = (batch, Tp, cfg.top_k) if Tp > 1 else (batch, cfg.top_k)
        c["plan_e"] = torch.zeros(shape, dtype=torch.int32, device=device)
        c["plan_w"] = torch.full(shape, 1.0 / cfg.top_k, dtype=torch.float32, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, pool_batch: Optional[int] = None) -> List[Params]:
    return [init_layer_cache(kind, cfg, batch, max_len, device, pool_batch) for kind in cfg.layer_kinds]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def default_moe_apply(cfg: ModelConfig) -> MoeApply:
    """The single-host MoE apply: :func:`moe.moe_layer` bound to ``cfg``."""

    def apply(x_ffn, route_src, p):
        return moe.moe_layer(x_ffn, route_src, p, cfg)

    return apply


def _ffn(kind, cfg, p, h, ffn_in, route_src, moe_apply: Optional[MoeApply] = None):
    """The layer's FFN on the prefill data plane; returns (y, next route_src)."""
    if kind == "moe":
        y, _ = (moe_apply or default_moe_apply(cfg))(ffn_in, route_src, p["moe"])
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
    moe_apply: Optional[MoeApply] = None,
):
    """Full-sequence pass that writes the prompt's K/V (and the seeded
    DecodePlan), or a ``rec``/``ssm`` layer's final state, into batch rows ``rows``
    of ``cache``, in place.  ``moe_apply`` runs an MoE layer's FFN
    (default :func:`default_moe_apply`).  The whole stripe is zeroed first
    (its scales set to ones), so the slot holds exactly what a fresh B=1
    cache written into it would.  A rolling buffer of W rows takes the
    prompt's last ``min(W, S)`` positions at slots ``pos % W``, where
    decode's modulo addressing continues.  An int8 cache takes the rows
    quantized (:func:`_quant_kv_rows`); attention here reads them in full
    precision."""
    B, S, _ = x.shape
    if kind == "rec":
        r, state = rglru.rec_block_prefill(L.rms_norm(x, p["ln1"]), p["rec"], cfg)
        for name, val in state.items():
            cache[name][rows] = val.to(cache[name].dtype)
        h = x + r
        return h + L.swiglu(L.rms_norm(h, p["ln2"]), p["ffn"]), route_src
    if kind == "ssm":
        s, state = mamba2.ssm_block(L.rms_norm(x, p["ln1"]), p["ssm"], cfg, return_state=True)
        for name, val in state.items():
            cache[name][rows] = val.to(cache[name].dtype)
        return x + s, route_src
    if "pk" in cache:
        raise ValueError(
            "prefill writes contiguous stripes; paged caches are seeded through "
            "admission (a contiguous B=1 prefill, then Model.write_cache_slot_paged)"
        )
    window = window_of(cfg, kind)
    W = cache["k"].shape[1]
    if S > W and not window:
        raise ValueError(f"prompt of {S} tokens exceeds the cache length {W}")
    xn = L.rms_norm(x, p["ln1"])
    q, k, v = L._qkv(xn, p["attn"], cfg, positions)
    take = min(W, S)
    slots = torch.arange(S - take, S, device=x.device) % W
    kw, vw = k[:, S - take:], v[:, S - take:]
    if "ks" in cache:
        kw, vw, ksr, vsr = _quant_kv_rows(kw, vw)
        for name, val in (("ks", ksr), ("vs", vsr)):
            stripe = cache[name][rows]
            stripe.fill_(1.0)
            stripe[:, slots] = val
    for name, val in (("k", kw), ("v", vw)):
        stripe = cache[name][rows]
        stripe.zero_()
        stripe[:, slots] = val.to(stripe.dtype)
    out = flash_attention(q, k, v, causal=True, window=window)
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
    y, route_src = _ffn(kind, cfg, p, h, ffn_in, route_src, moe_apply)
    return h + y, route_src


def apply_layer_train(
    x: torch.Tensor,                    # (B, S, d)
    route_src: Optional[torch.Tensor],
    p: Params,
    kind: str,
    cfg: ModelConfig,
    positions: torch.Tensor,            # (B, S)
    moe_apply=None,
):
    """One layer, training-style full-sequence pass (no cache), each
    weight cast to the activations' type at use; the reference's ``_res``
    barrier is the identity.  ``attn``/``local``/``moe``: the pre-norm
    attention sub-block through kernel 7 and its backward
    (:func:`layers.attention_block_train`), then the SwiGLU FFN, or for
    ``moe`` the routed experts through kernels 3/4 and their backward
    (:func:`moe.moe_layer`; ``aux`` its [load-balance, z] losses, and
    ``h`` the next layer's ``route_src``).  ``rec``: the RG-LRU block
    through kernel 12 and its backward (:func:`rglru.rec_block_prefill`'s
    output), then the SwiGLU FFN.  ``ssm``: the Mamba-2 block through
    kernel 11 and its backward (:func:`mamba2.ssm_block`), with no FFN.
    ``moe_apply`` ``(x_ffn, route_src, p) -> (y, aux (2,))`` replaces
    ``moe_layer`` (a mesh's expert-parallel apply).  Returns ``(x,
    route_src, aux)``, ``aux`` (2,) f32 (zeros without a router)."""
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    if kind == "ssm":
        return x + mamba2.ssm_block(L.rms_norm(x, p["ln1"]), p["ssm"], cfg), route_src, aux
    if kind == "rec":
        h = x + rglru.rec_block_prefill(L.rms_norm(x, p["ln1"]), p["rec"], cfg)[0]
        return h + L.swiglu(L.rms_norm(h, p["ln2"]), p["ffn"]), route_src, aux
    a = L.attention_block_train(L.rms_norm(x, p["ln1"]), p["attn"], cfg, positions=positions,
                                local_window=window_of(cfg, kind))
    h = x + a
    ffn_in = L.rms_norm(h, p["ln2"])
    if kind == "moe":
        if moe_apply is not None:
            y, a = moe_apply(ffn_in, route_src, p["moe"])
            return h + y, h, a
        y, r = moe.moe_layer(ffn_in, route_src, p["moe"], cfg)
        return h + y, h, torch.stack([r.load_balance_loss, r.router_z_loss])
    return h + L.swiglu(ffn_in, p["ffn"]), route_src, aux


def _attn_out(out: torch.Tensor, p: Params) -> torch.Tensor:
    return torch.einsum("btnh,nhd->btd", out, p["wo"])


def _quant_kv_rows(k: torch.Tensor, v: torch.Tensor):
    """Quantize new K/V rows per TOKEN: (..., nkv, hd) -> int8 rows and one
    f32 scale per row (..., ).  The row is the unit speculative rollback,
    tree commit and paged CoW move, so every cache mutation stays an
    (int8 row, scale) pair move.  (The reference's ``_deq``, the f32 view
    its masked-jnp paths read, is the plain versions'
    :func:`repro_torch.kernels.flash_attention.ref.dequantize_rows`.)"""
    kq, ks = quantize_int8(k.to(torch.float32), axis=(-2, -1))
    vq, vs = quantize_int8(v.to(torch.float32), axis=(-2, -1))
    return kq, vq, ks[..., 0, 0].to(torch.float32), vs[..., 0, 0].to(torch.float32)


def _write_rows(cache: Params, names, idx, k: torch.Tensor, v: torch.Tensor):
    """Write this launch's K/V rows at ``idx`` (an index tuple) into the
    leaves ``names`` (payload K, payload V, scale K, scale V), quantized
    when the cache holds scales; returns the (K, V) scale leaves the decode
    kernel takes, or None."""
    nk, nv, nks, nvs = names
    if nks in cache:
        k, v, ksr, vsr = _quant_kv_rows(k, v)
        cache[nks][idx] = ksr
        cache[nvs][idx] = vsr
    cache[nk][idx] = k.to(cache[nk].dtype)
    cache[nv][idx] = v.to(cache[nv].dtype)
    return (cache[nks], cache[nvs]) if nks in cache else None


@functools.lru_cache(maxsize=32)
def _tree_tensors(tree: TreePlan, device: torch.device):
    """(depths int64, ancestor words int32, parents of nodes 1.. int64) on
    ``device``, made once per tree: every layer of every launch reads them,
    and copying a host list to the card per layer would stall the host."""
    return (torch.tensor(tree.depths(), dtype=torch.int64, device=device),
            torch.tensor(tree.ancestor_words(), dtype=torch.int32, device=device),
            torch.tensor(tree.parents[1:], dtype=torch.int64, device=device))


def decode_constants(cfg: ModelConfig, tree: TreePlan, device: torch.device) -> List[torch.Tensor]:
    """The device tensors a decode launch under ``tree`` reads from the
    process-wide caches rather than from its params or cache (the tree's
    control words, the rotary frequencies), on ``device`` as a tensor names
    it (with its index).  A CUDA graph keeps their addresses, so a compiled
    launch holds these references for as long as its graph lives."""
    return [*_tree_tensors(tree, device), L.rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta, device)]


def _tree_rows(lengths: torch.Tensor, tree: TreePlan):
    """(cache rows, rotary positions), both (B, T): node t sits at row
    ``lengths + t`` (each node needs its own KV row; siblings share a depth)
    and position ``lengths + depth(t)`` (its sequential position)."""
    dev = lengths.device
    depths = _tree_tensors(tree, dev)[0]
    base = lengths[:, None].to(torch.int64)
    return base + torch.arange(tree.num_nodes, dtype=torch.int64, device=dev)[None, :], base + depths[None, :]


def _decode_attn_prefix_tree(
    xn: torch.Tensor,       # (B, T, d): T draft-tree nodes per sequence
    p: Params,
    cfg: ModelConfig,
    cache: Params,
    lengths: torch.Tensor,  # (B,) committed-prefix length per sequence
    tree: TreePlan,
) -> torch.Tensor:
    """Ancestor-masked T-node attention: a row is visible to node t iff it
    is below the committed prefix or on t's root path, exactly the keys a
    sequential decode of that path would see.  A chain is
    ``TreePlan.chain(T)``: its words make node t see rows ``[0, lengths +
    t]``, the per-token valid prefix of linear speculation.  The new K/V
    rows are written into the cache in place first."""
    B = xn.shape[0]
    rows, pos = _tree_rows(lengths, tree)
    q, k, v = L._qkv(xn, p, cfg, pos)
    bidx = torch.arange(B, device=xn.device)[:, None]
    scales = _write_rows(cache, KV_LEAVES, (bidx, rows), k, v)
    base = lengths.to(torch.int32)
    out = flash_decode(q, cache["k"], cache["v"], lengths, ancestors=_tree_tensors(tree, xn.device)[1], base=base,
                       scales=scales)
    return _attn_out(out, p)


def _decode_attn_rolling(
    xn: torch.Tensor,       # (B, T, d): T chain tokens per sequence
    p: Params,
    cfg: ModelConfig,
    cache: Params,
    lengths: torch.Tensor,  # (B,) tokens already in each sequence
    window: int,
) -> torch.Tensor:
    """T-token attention against a rolling (modulo-addressed) buffer of W
    slots: the T new K/V rows land at slots ``pos % W`` first, then token t
    at position ``pos = lengths + t`` attends to positions
    ``(pos - min(window, W), pos]`` that still hold their slot after this
    launch's writes, so a draft token never sees a later one (the window
    kernel, :func:`repro_torch.kernels.flash_attention.flash_decode_window`)."""
    B, T, _ = xn.shape
    W = cache["k"].shape[1]
    if T > W:
        raise ValueError(f"a launch of {T} tokens exceeds the rolling buffer of {W} slots")
    pos = lengths[:, None].to(torch.int64) + torch.arange(T, dtype=torch.int64, device=xn.device)[None, :]
    q, k, v = L._qkv(xn, p, cfg, pos)
    bidx = torch.arange(B, device=xn.device)[:, None]
    slots = torch.remainder(pos, W)
    scales = _write_rows(cache, KV_LEAVES, (bidx, slots), k, v)
    out = flash_decode_window(q, cache["k"], cache["v"], lengths, window=window, scales=scales)
    return _attn_out(out, p)


def _decode_attn_rolling_tree(
    xn: torch.Tensor,       # (B, T, d): T draft-tree nodes per sequence
    p: Params,
    cfg: ModelConfig,
    cache: Params,
    lengths: torch.Tensor,  # (B,) committed-prefix length per sequence
    window: int,
    tree: TreePlan,
) -> torch.Tensor:
    """Ancestor-masked tree attention against a rolling (modulo) buffer, in
    plain torch as in the reference (which has no kernel for it).

    Node t lands at slot ``(lengths + t) % W`` with rotary position
    ``lengths + depth(t)``.  A slot is visible to node t iff it holds a
    written row, lies inside t's window measured in SEQUENTIAL positions (a
    draft row's is ``lengths + depth``, a committed row's its position), and
    is committed or on t's root path.  The accepted path's moves arrive as
    the next launch's commit maps, mod W (:func:`_apply_commit`).  An int8
    buffer is read dequantized (its scale rows are written with the
    payload)."""
    B, T, _ = xn.shape
    W = cache["k"].shape[1]
    if T > W:
        raise ValueError(f"a draft tree of {T} nodes exceeds the rolling buffer of {W} slots")
    dev = xn.device
    depths, words, _ = _tree_tensors(tree, dev)
    nodes = torch.arange(T, dtype=torch.int64, device=dev)
    base = lengths[:, None].to(torch.int64)
    pos = base + depths[None, :]
    q, k, v = L._qkv(xn, p, cfg, pos)
    bidx = torch.arange(B, device=dev)[:, None]
    scales = _write_rows(cache, KV_LEAVES, (bidx, torch.remainder(base + nodes[None, :], W)), k, v)
    limit = min(window, W)
    hd, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
    head = base + T - 1  # (B, 1): the last written row's position
    slot = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    abs_pos = head - torch.remainder(torch.remainder(head, W) - slot, W)  # (B, W)
    u = abs_pos - base  # draft-row index of each slot (>= 0 iff a draft row)
    in_draft = (u >= 0) & (u < T)
    uc = u.clamp(0, T - 1)
    table = ((words[:, None].to(torch.int64) >> nodes[None, :]) & 1).bool()  # (T, T): u on t's root path
    anc_ok = table[:, uc].permute(1, 0, 2)  # (B, T, W)
    eff = torch.where(in_draft, base + depths[uc], abs_pos)
    valid = ((abs_pos >= 0)[:, None, :] & (eff[:, None, :] > pos[:, :, None] - limit)
             & ((u < 0)[:, None, :] | (in_draft[:, None, :] & anc_ok)))  # (B, T, W)
    ck, cv = cache["k"], cache["v"]
    if scales is not None:
        ck, cv = dequantize_rows(ck, scales[0]), dequantize_rows(cv, scales[1])
    qg = q.reshape(B, T, nkv, cfg.num_heads // nkv, hd).to(torch.float32)
    s = torch.einsum("btngh,bsnh->bngts", qg, ck.to(torch.float32)) * (1.0 / math.sqrt(hd))
    s = torch.where(valid[:, None, None], s, torch.full_like(s, L.NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bngts,bsnh->btngh", w, cv.to(torch.float32)).reshape(B, T, cfg.num_heads, hd)
    return _attn_out(out.to(xn.dtype), p)


def _paged_rows(pages: torch.Tensor, pos: torch.Tensor, ps: int, R: int) -> torch.Tensor:
    """Translate logical positions to physical pool rows via the block table.

    ``pages`` is (B, max_pages) (-1 = unallocated); ``pos`` is (B, T)
    logical absolute positions.  Unmapped positions resolve to row ``R``,
    the pool's trash row."""
    idx = torch.clamp(pos // ps, max=pages.shape[1] - 1)
    phys = torch.gather(pages, 1, idx).to(torch.int64)
    return torch.where(phys >= 0, phys * ps + pos % ps, torch.full_like(phys, R))


def _pool_size(cache: Params) -> int:
    """R: the pool's real rows (the last row is the trash row)."""
    return cache["pk"].shape[0] - 1


def _apply_commit(
    cache: Params,
    commit: Tuple[torch.Tensor, torch.Tensor],
    pages: Optional[torch.Tensor],
    cfg: ModelConfig,
) -> None:
    """Fused tree commit, in place: move the accepted path's KV rows, one
    gather and one scatter, at the top of the decode launch (before any new
    writes).  ``commit = (dst, src)`` are (B, Tc) LOGICAL positions with -1
    as the no-op; pool caches translate through the block table, rolling
    caches (unpaged under ``cfg.paged``) move slots mod W.  The gather lands
    in a temporary before the scatter, so overlapping (dst, src) windows
    are safe.  A pool's no-op moves land in its trash row; a rolling
    buffer has none, so its no-op entry i rewrites the slot of position
    ``L + i`` with its own old value (L, the pre-accept length, is
    ``dst - i`` of any real move of the row; no real move of the row
    writes that slot, and a row with none rewrites slots i): the
    reference's dropped write, with no host read.  An int8 cache's scale
    rows move with their payload, through the same maps."""
    dst, src = commit
    if "pk" not in cache:
        B, W = cache["k"].shape[:2]
        Tc = dst.shape[1]
        col = torch.arange(Tc, dtype=dst.dtype, device=dst.device)[None, :]
        base = torch.where(dst >= 0, dst - col, torch.full_like(dst, -1)).amax(dim=1, keepdim=True).clamp(min=0)
        own = torch.remainder(base + col, W)
        dst_slot = torch.where(dst >= 0, torch.remainder(dst, W), own)
        src_slot = torch.where(dst >= 0, torch.remainder(src.clamp(min=0), W), own)
        bidx = torch.arange(B, device=dst.device)[:, None]
        for name in KV_LEAVES:
            if name in cache:
                moved = cache[name][bidx, src_slot]
                cache[name][bidx, dst_slot] = moved
        return
    R, ps = _pool_size(cache), cfg.page_size
    src_rows = torch.clamp(_paged_rows(pages, src.clamp(min=0), ps, R), max=R - 1)
    dst_rows = torch.where(dst >= 0, _paged_rows(pages, dst.clamp(min=0), ps, R), torch.full_like(dst, R))
    for name in POOL_LEAVES:
        if name in cache:
            moved = cache[name][src_rows]
            cache[name][dst_rows] = moved


def cow_copy_page(cache: List[Params], old_page: int, new_page: int, page_size: int) -> List[Params]:
    """Copy-on-write page duplication, in place: after
    :meth:`repro_torch.core.pages.PageTable.ensure_writable` rebinds a shared
    page, copy the old physical page's rows into the fresh one in every
    layer's pool: the payload AND, for an int8 pool, the scale rows (a page
    is the (int8 rows, scale rows) pair; aliasing the scales would let the
    writer's next row corrupt the sibling still reading the shared page).
    Returns ``cache``."""
    o0, n0 = int(old_page) * page_size, int(new_page) * page_size
    for c in cache:
        for name in POOL_LEAVES:
            if name in c:
                c[name][n0:n0 + page_size] = c[name][o0:o0 + page_size]
    return cache


def _decode_attn_paged_tree(
    xn: torch.Tensor,       # (B, T, d): T draft-tree nodes per sequence
    p: Params,
    cfg: ModelConfig,
    cache: Params,
    lengths: torch.Tensor,  # (B,) committed-prefix length per sequence
    tree: TreePlan,
    pages: torch.Tensor,    # (B, max_pages) int32 block table
) -> torch.Tensor:
    """Paged twin of :func:`_decode_attn_prefix_tree`: node t occupies
    LOGICAL row ``lengths[b] + t`` (physical row via the block table); the
    ancestor mask works on logical rows, so the physical layout never leaks
    into the math."""
    ps = cfg.page_size
    lrows, pos = _tree_rows(lengths, tree)
    q, k, v = L._qkv(xn, p, cfg, pos)
    rows = _paged_rows(pages, lrows, ps, _pool_size(cache))
    scales = _write_rows(cache, POOL_LEAVES, (rows,), k, v)
    out = flash_decode_paged(
        q, cache["pk"], cache["pv"], lengths, pages, page_size=ps,
        ancestors=_tree_tensors(tree, xn.device)[1], base=lengths.to(torch.int32), scales=scales,
    )
    return _attn_out(out, p)


def apply_layer_decode_spec(
    x: torch.Tensor,             # (B, T, d): T chain tokens (or tree nodes) per sequence
    route_src: Optional[torch.Tensor],
    p: Params,
    cache: Params,
    kind: str,
    cfg: ModelConfig,
    lengths: torch.Tensor,       # (B,) per-sequence cache length
    prev_accept: torch.Tensor,   # (B,) accepted-row index into the plan vector
    *,
    telemetry: bool = False,
    tree: Optional[TreePlan] = None,
    pages: Optional[torch.Tensor] = None,   # (B, max_pages) block table
    commit: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (dst, src) (B, Tc)
    moe_apply: Optional[MoeApply] = None,
    decode_apply: Optional[DecodeApply] = None,
):
    """One layer of a speculative launch; updates ``cache`` in place.
    ``decode_apply`` executes a decode-plane MoE layer's plan (default
    :func:`moe.moe_decode_ffn`), ``moe_apply`` any other MoE layer's FFN.

    Plan semantics reproduce T sequential single-token steps: token 0
    consumes the cached plan row ``prev_accept`` selects, token t >= 1 the
    plan routed in this launch from its PARENT's route source; all T routed
    plans are written back as the next launch's plan vector.  ``tree=None``
    is the chain ``TreePlan.chain(T)`` (the parent of t is t-1): chains and
    trees run one path.  Paged caches take the block table ``pages`` and
    the previous verify round's commit maps ``commit``, applied before this
    launch writes.

    Local-attention layers serve chains through the rolling buffer
    (:func:`_decode_attn_rolling`) and, under ``cfg.paged`` (whose commit
    maps move their accepted rows mod W), branchy trees through
    :func:`_decode_attn_rolling_tree`; the contiguous plane refuses
    branchy trees on them, as the reference does.  ``rec`` and ``ssm``
    layers run one RG-LRU or SSD step at T = 1 and refuse T > 1
    (:func:`check_spec_width`).

    Returns ``(x, route_src, agreement)``: the stale-vs-fresh top-k plan
    agreement of this layer as a 0-d tensor when ``telemetry`` is set and
    the layer is a decode-plane MoE layer, else None."""
    B, T, d = x.shape
    if kind == "rec":
        check_spec_width(cfg, T)
        r = rglru.rec_block_decode(L.rms_norm(x, p["ln1"]), p["rec"], cfg, cache)
        h = x + r
        return h + L.swiglu(L.rms_norm(h, p["ln2"]), p["ffn"]), route_src, None
    if kind == "ssm":
        check_spec_width(cfg, T)
        return x + mamba2.ssm_block_decode(L.rms_norm(x, p["ln1"]), p["ssm"], cfg, cache), route_src, None
    paged = "pk" in cache
    if commit is not None:
        _apply_commit(cache, commit, pages, cfg)
    if tree is None:
        tree = TreePlan.chain(T)
    window = window_of(cfg, kind)
    rolling_tree = bool(window) and not tree.is_chain()
    if rolling_tree and not cfg.paged:
        raise NotImplementedError(
            "branchy draft trees on rolling-window layers need the paged "
            "KV plane's fused commit maps (cfg.paged=True); the legacy "
            "contiguous path serves local-attention archs with chain "
            "drafts only"
        )
    xn = L.rms_norm(x, p["ln1"])
    if rolling_tree:
        a = _decode_attn_rolling_tree(xn, p["attn"], cfg, cache, lengths, window, tree)
    elif window:
        a = _decode_attn_rolling(xn, p["attn"], cfg, cache, lengths, window)
    elif paged:
        a = _decode_attn_paged_tree(xn, p["attn"], cfg, cache, lengths, tree, pages)
    else:
        a = _decode_attn_prefix_tree(xn, p["attn"], cfg, cache, lengths, tree)
    h = x + a
    ffn_in = L.rms_norm(h, p["ln2"])
    agree = None
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
        # node t consumes the plan routed from its parent's route source
        # (a chain gathers rows 0..T-2: the linear shift)
        par = _tree_tensors(tree, x.device)[2]
        prev_e, prev_w = all_e[:, par], all_w[:, par]
        cons_e = torch.cat([first_e[:, None], prev_e], dim=1)
        cons_w = torch.cat([first_w[:, None], prev_w], dim=1)
        y = (decode_apply or moe.moe_decode_ffn)(ffn_in, DecodePlan(cons_e, cons_w), p["moe"])
        if cached_e.ndim == 3:
            cached_e.copy_(all_e)
            cached_w.copy_(all_w)
        else:
            cached_e.copy_(all_e[:, -1])
            cached_w.copy_(all_w[:, -1])
        if telemetry:
            # stale (consumed) vs fresh (same position's source): the
            # decode plane's lookahead bet
            agree = topk_agreement(cons_e.reshape(B * T, k_), all_e.reshape(B * T, k_))
        route_src = h
    else:
        y, route_src = _ffn(kind, cfg, p, h, ffn_in, route_src, moe_apply)
    return h + y, route_src, agree
