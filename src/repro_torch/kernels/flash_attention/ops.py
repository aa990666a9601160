"""Flash-decode wrappers (port of ``repro/kernels/flash_attention/decode.py``).

:func:`flash_decode_kernel` is the launch: on CPU tensors it runs the plain
version (:mod:`.ref`), on ``cuda`` tensors it launches
``csrc/flash_decode.cu`` or raises.  :func:`flash_decode` is the model-layout
entry point (the reference's ``flash_decode``): it builds the per-token
length vector from the cache index.  Unlike the TPU wrapper it neither
transposes nor pads the cache: the kernel reads the (B, S, nkv, hd) buffer in
place.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ref


def _as_length_vector(cache_index, B: int, T: int, device) -> torch.Tensor:
    """Promote a scalar / (B,) / (B, T) cache index to the (B*T,) length vector.

    scalar i       -> token (b, t) sees prefix [0, i + t]
    (B,) idx       -> token (b, t) sees prefix [0, idx[b] + t]
    (B, T) idx     -> fully explicit per-token indices
    """
    idx = torch.as_tensor(cache_index, dtype=torch.int32, device=device)
    if idx.ndim == 0:
        idx = idx.expand(B)
    if idx.ndim == 1:
        idx = idx[:, None] + torch.arange(T, dtype=torch.int32, device=device)[None, :]
    return (idx + 1).reshape(B * T).to(torch.int32)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode: {msg}")


def flash_decode_kernel(
    q: torch.Tensor,        # (B, T, nq, hd)
    k: torch.Tensor,        # (B, S, nkv, hd) cache buffer, model layout
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B*T,) int32 valid prefix length per token
    anc_words: Optional[torch.Tensor] = None,  # (T,) int32 ancestor bitmasks
    base: Optional[torch.Tensor] = None,       # (B,) int32 committed-prefix length
    scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Vector-steered decode attention; (B, T, nq, hd) in q's type."""
    if scales is not None:
        raise NotImplementedError("int8 KV (per-row scales) is ported in a later slice")
    B, T, nq, hd = q.shape
    _check(k.ndim == 4 and k.shape[0] == B and k.shape[3] == hd, f"k shape {tuple(k.shape)}")
    _check(v.shape == k.shape, f"v shape {tuple(v.shape)} != k shape {tuple(k.shape)}")
    S, nkv = k.shape[1], k.shape[2]
    _check(nq % nkv == 0, f"{nq} query heads not a multiple of {nkv} kv heads")
    _check(q.dtype == k.dtype == v.dtype, f"dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    dev = q.device
    if anc_words is None:
        # chain default: all-ones words make the ancestor test vacuous
        anc_words = torch.full((T,), -1, dtype=torch.int32, device=dev)
    if base is None:
        base = torch.zeros((B,), dtype=torch.int32, device=dev)
    for name, t, n in (("lengths", lengths, B * T), ("anc_words", anc_words, T), ("base", base, B)):
        _check(t.dtype == torch.int32 and t.numel() == n, f"{name} must be ({n},) int32")
    _check(all(t.device == dev for t in (k, v, lengths, anc_words, base)), "tensors on different devices")
    if dev.type == "cpu":
        return ref.flash_decode(q, k, v, lengths, anc_words, base)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    _check(all(t.is_contiguous() for t in (q, k, v, lengths, anc_words, base)), "tensors must be contiguous")
    fn = function(
        "flash_decode", "repro_flash_decode",
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
    )
    out = torch.empty_like(q)
    rc = fn(
        dtype_code(q.dtype), ptr(q), ptr(k), ptr(v), ptr(out), ptr(lengths), ptr(anc_words), ptr(base),
        B, T, S, nq, nkv, hd, 1.0 / math.sqrt(hd), stream_of(q),
    )
    check_launch(rc, "flash_decode")
    flash_decode_kernel.launches += 1
    return out


flash_decode_kernel.launches = 0


def flash_decode(
    q: torch.Tensor,   # (B, T, nq, hd) model layout
    k: torch.Tensor,   # (B, S, nkv, hd) cache buffer already holding this launch's K
    v: torch.Tensor,
    cache_index,       # scalar | (B,) | (B, T) token position(s)
    *,
    ancestors: Optional[torch.Tensor] = None,
    base: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-token attention over each token's valid cache prefix: token
    (b, t) attends to positions [0, index(b, t)]; with ``ancestors``/``base``
    draft rows are further masked by the tree's ancestor words."""
    B, T = q.shape[:2]
    lengths = _as_length_vector(cache_index, B, T, q.device)
    return flash_decode_kernel(q, k, v, lengths, ancestors, base, scales)
