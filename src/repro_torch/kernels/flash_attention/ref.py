"""Plain PyTorch versions of the flash-attention kernels
(``csrc/flash_decode.cu``, ``csrc/flash_attention.cu``).

The same functions in tensor ops: token (b, t) attends to cache rows
``p < lengths[b*T + t]`` that are on its root path (``p < base[b]`` or bit
``p - base[b]`` of ``anc[t]`` set), GQA head ``h`` reading KV head
``h // group``, in f32; the output has q's type.  The paged version reads
logical row ``p`` of sequence ``b`` from pool row
``max(table[b, p // ps], 0) * ps + p % ps``.  The window version masks a
rolling buffer's slots by the absolute position each holds, reconstructed
from the launch's last write (the reference's jnp path); the prefill
version is the model's blockwise attention (``layers.blockwise_attention``),
as the reference's ``flash_attention/ref.py`` is.  Its training
counterparts: :func:`flash_attention_lse` adds each row's log-sum-exp, and
:func:`flash_attention_bwd` is the backward written out (the gradient the
reference takes by autodiff through the blockwise attention), both over
the whole (Sq, Skv) score matrix in f32.

With ``scales`` the cache is int8 and is dequantized elementwise (one f32
scale per cache row, ``scales[0]`` K's and ``scales[1]`` V's) before any
contraction, as the kernels' int8 branch does, so each version with
``scales`` is bitwise itself on the dequantized f32 cache.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quant import dequantize_int8
from repro_torch.models.layers import blockwise_attention


def visible_rows(lengths: torch.Tensor, anc: torch.Tensor, base: torch.Tensor, B: int, T: int, S: int) -> torch.Tensor:
    """(B, T, S) bool: the cache rows each token may attend to."""
    p = torch.arange(S, device=lengths.device)
    in_len = p[None, None, :] < lengths.reshape(B, T)[:, :, None]
    u = p[None, None, :] - base.reshape(B, 1, 1)
    bit = (anc.reshape(1, T, 1).to(torch.int64) >> u.clamp(0, 31)) & 1
    return in_len & ((u < 0) | (bit > 0))


def dequantize_rows(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The f32 view of an int8 cache buffer (..., nkv, hd) with one f32
    scale per row (the leading shape, flattened or not)."""
    return dequantize_int8(c, s.reshape(c.shape[:-2])[..., None, None])


def flash_decode(
    q: torch.Tensor,        # (B, T, nq, hd)
    k: torch.Tensor,        # (B, S, nkv, hd); int8 with scales
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B*T,) int32
    anc: torch.Tensor,      # (T,) int32
    base: torch.Tensor,     # (B,) int32
    scales=None,  # (ks, vs) or (2, ...): B*S f32 per-row K/V scales each
) -> torch.Tensor:
    B, T, nq, hd = q.shape
    if scales is not None:
        k, v = dequantize_rows(k, scales[0]), dequantize_rows(v, scales[1])
    S, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(B, T, nkv, g, hd).to(torch.float32)
    s = torch.einsum("btngh,bsnh->bngts", qg, k.to(torch.float32)) * (1.0 / math.sqrt(hd))
    vis = visible_rows(lengths, anc, base, B, T, S)[:, None, None]  # (B, 1, 1, T, S)
    s = s.masked_fill(~vis, float("-inf"))
    w = torch.softmax(s, dim=-1).nan_to_num(0.0)  # a token with no visible row reads zeros
    out = torch.einsum("bngts,bsnh->btngh", w, v.to(torch.float32))
    return out.reshape(B, T, nq, hd).to(q.dtype)


def flash_decode_paged(
    q: torch.Tensor,        # (B, T, nq, hd)
    pool_k: torch.Tensor,   # (R, nkv, hd) flat page pool
    pool_v: torch.Tensor,
    lengths: torch.Tensor,  # (B*T,) int32
    table: torch.Tensor,    # (B*mp,) int32 block tables (-1 = unallocated)
    anc: torch.Tensor,      # (T,) int32
    base: torch.Tensor,     # (B,) int32
    page_size: int,
    scales=None,  # (ks, vs) or (2, ...): R f32 per-pool-row K/V scales each
) -> torch.Tensor:
    """Gather each sequence's logical rows through its block table, then the
    contiguous version.  An unallocated entry reads page 0, as the kernel's
    clamp does; callers keep such pages past every token's length.  An
    int8 pool is dequantized (each row by its pool row's scale) first."""
    B = q.shape[0]
    if scales is not None:
        pool_k, pool_v = dequantize_rows(pool_k, scales[0]), dequantize_rows(pool_v, scales[1])
    mp = table.numel() // B
    pages = table.reshape(B, mp).to(torch.int64).clamp(min=0)
    rows = (pages * page_size)[:, :, None] + torch.arange(page_size, device=q.device)
    rows = rows.reshape(B, mp * page_size)
    return flash_decode(q, pool_k[rows], pool_v[rows], lengths, anc, base)


def flash_decode_window(
    q: torch.Tensor,          # (B, T, nq, hd)
    k: torch.Tensor,          # (B, W, nkv, hd) rolling buffer, slot = position % W
    v: torch.Tensor,
    positions: torch.Tensor,  # (B*T,) int32 absolute position per token
    limit: int,               # min(window, W)
    scales=None,  # (ks, vs) or (2, ...): B*W f32 per-slot K/V scales each
) -> torch.Tensor:
    """Slot s holds the largest position <= head with p % W == s (head = the
    launch's last position); token (b, t) sees the slots whose position p
    has ``0 <= p <= pos`` and ``p > pos - limit``."""
    B, T, nq, hd = q.shape
    if scales is not None:
        k, v = dequantize_rows(k, scales[0]), dequantize_rows(v, scales[1])
    W, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    pos = positions.reshape(B, T).to(torch.int64)
    head = pos[:, -1]
    slot = torch.arange(W, device=q.device)
    abs_pos = head[:, None] - torch.remainder(torch.remainder(head, W)[:, None] - slot[None, :], W)  # (B, W)
    ap = abs_pos[:, None, :]
    vis = (ap >= 0) & (ap <= pos[:, :, None]) & (ap > pos[:, :, None] - limit)  # (B, T, W)
    qg = q.reshape(B, T, nkv, g, hd).to(torch.float32)
    s = torch.einsum("btngh,bsnh->bngts", qg, k.to(torch.float32)) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~vis[:, None, None], float("-inf"))
    w = torch.softmax(s, dim=-1).nan_to_num(0.0)
    out = torch.einsum("bngts,bsnh->btngh", w, v.to(torch.float32))
    return out.reshape(B, T, nq, hd).to(q.dtype)


def flash_attention(
    q: torch.Tensor,   # (B, Sq, nq, hd)
    k: torch.Tensor,   # (B, Skv, nkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    return blockwise_attention(q, k, v, causal=causal, local_window=window)


def _scores(q, k, causal: bool, window: int):
    """(B, nq, Sq, Skv) f32 scaled scores, -inf where a query does not see
    the key, and k's heads expanded to q's (GQA)."""
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    kx = k.repeat_interleave(nq // nkv, dim=2)
    s = torch.einsum("bqnh,bknh->bnqk", q.to(torch.float32), kx.to(torch.float32)) * (1.0 / math.sqrt(hd))
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Skv, device=q.device)[None, :]
    vis = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        vis &= j <= i
    if window:
        vis &= i - j < window
    return s.masked_fill(~vis, float("-inf"))


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """(out, lse): :func:`flash_attention`'s output and the (B, Sq, nq) f32
    log-sum-exp of each row's scaled scores (+inf for a row that sees no
    key, as the kernel writes it)."""
    lse = torch.logsumexp(_scores(q, k, causal, window), dim=-1).permute(0, 2, 1)
    lse = lse.masked_fill(lse == float("-inf"), float("inf")).contiguous()
    return flash_attention(q, k, v, causal=causal, window=window), lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0):
    """(dq, dk, dv) in the inputs' type: P = exp(s - lse), D = rowsum(dout
    * out), dS = P (dout v^T - D), dq = scale dS k, dk = scale dS^T q
    (summed over each kv head's query group), dv = P^T dout; f32 inside."""
    B, Sq, nq, hd = q.shape
    nkv = k.shape[2]
    G = nq // nkv
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    p = torch.exp(_scores(q, k, causal, window) - lse.permute(0, 2, 1)[..., None].to(f32))
    do = dout.to(f32)
    vx = v.repeat_interleave(G, dim=2).to(f32)
    dp = torch.einsum("bqnh,bknh->bnqk", do, vx)
    d = (do * out.to(f32)).sum(dim=-1).permute(0, 2, 1)[..., None]  # (B, nq, Sq, 1)
    ds = p * (dp - d)
    kx = k.repeat_interleave(G, dim=2).to(f32)
    dq = torch.einsum("bnqk,bknh->bqnh", ds, kx) * scale
    dk = torch.einsum("bnqk,bqnh->bknh", ds, q.to(f32)) * scale
    dv = torch.einsum("bnqk,bqnh->bknh", p, do)
    Skv = k.shape[1]
    dk = dk.reshape(B, Skv, nkv, G, hd).sum(dim=3)
    dv = dv.reshape(B, Skv, nkv, G, hd).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
