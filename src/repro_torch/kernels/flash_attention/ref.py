"""Plain PyTorch version of the flash-decode kernel (``csrc/flash_decode.cu``).

The same function in tensor ops: token (b, t) attends to cache rows
``p < lengths[b*T + t]`` that are on its root path (``p < base[b]`` or bit
``p - base[b]`` of ``anc[t]`` set), GQA head ``h`` reading KV head
``h // group``, in f32; the output has q's type.
"""
from __future__ import annotations

import math

import torch


def visible_rows(lengths: torch.Tensor, anc: torch.Tensor, base: torch.Tensor, B: int, T: int, S: int) -> torch.Tensor:
    """(B, T, S) bool: the cache rows each token may attend to."""
    p = torch.arange(S, device=lengths.device)
    in_len = p[None, None, :] < lengths.reshape(B, T)[:, :, None]
    u = p[None, None, :] - base.reshape(B, 1, 1)
    bit = (anc.reshape(1, T, 1).to(torch.int64) >> u.clamp(0, 31)) & 1
    return in_len & ((u < 0) | (bit > 0))


def flash_decode(
    q: torch.Tensor,        # (B, T, nq, hd)
    k: torch.Tensor,        # (B, S, nkv, hd)
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B*T,) int32
    anc: torch.Tensor,      # (T,) int32
    base: torch.Tensor,     # (B,) int32
) -> torch.Tensor:
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(B, T, nkv, g, hd).to(torch.float32)
    s = torch.einsum("btngh,bsnh->bngts", qg, k.to(torch.float32)) * (1.0 / math.sqrt(hd))
    vis = visible_rows(lengths, anc, base, B, T, S)[:, None, None]  # (B, 1, 1, T, S)
    s = s.masked_fill(~vis, float("-inf"))
    w = torch.softmax(s, dim=-1).nan_to_num(0.0)  # a token with no visible row reads zeros
    out = torch.einsum("bngts,bsnh->btngh", w, v.to(torch.float32))
    return out.reshape(B, T, nq, hd).to(q.dtype)
