"""Flash-attention wrappers (port of ``repro/kernels/flash_attention``:
``decode.py``, ``kernel.py`` and ``ops.py``).

:func:`flash_decode_kernel`, :func:`flash_decode_paged_kernel`,
:func:`flash_decode_window_kernel` and :func:`flash_attention_kernel` are
the launches: on CPU tensors they run the plain versions (:mod:`.ref`), on
``cuda`` tensors they launch ``csrc/flash_decode.cu`` (the three decode
instantiations) or ``csrc/flash_attention.cu`` (prefill), or raise.
:func:`flash_decode`, :func:`flash_decode_paged`,
:func:`flash_decode_window` and :func:`flash_attention` are the
model-layout entry points (the reference's functions of the same names):
they build the per-token control words from the cache index.  Unlike the
TPU wrappers they neither transpose, pad nor reshape: the kernels read the
(B, S, nkv, hd) cache, the rolling (B, W, nkv, hd) buffer and the
(R, nkv, hd) page pool in place.

int8 caches: the three decode entry points take ``scales`` in the
reference's layouts, (2, B, S) contiguous, (2, R) paged (one per pool row,
the trash row included) and (2, B, W) rolling, row 0 K's and row 1 V's, or
as the pair (K's, V's) of those shapes that the cache holds (the model
passes its ``ks``/``vs`` leaves so, without stacking them); the launches
then read int8 K/V and multiply each row by its scale before any dot (the
int8 branch, counted in ``int8_launches``).  On a ``cuda`` tensor
the int8 branch launches or raises: it never dequantizes and calls the
full-precision kernel, and never drops to the plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import check_launch, count_launch, dtype_code, function, ptr, stream_of
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


def _check(cond: bool, msg, what: str = "flash_decode") -> None:
    """Raise ``ValueError`` unless ``cond``.  ``msg`` is a string or, where
    building it costs host time on every launch, a function that builds it
    (called only on failure)."""
    if not cond:
        raise ValueError(f"{what}: {msg() if callable(msg) else msg}")


def _check_types(q, k, v, scales, rows: int, what: str) -> tuple:
    """The K/V type contract: without ``scales`` q, k and v share f32 or
    bf16; with them k and v are int8, q f32 or bf16, and ``scales`` is the
    pair (ks, vs) of f32 tensors of ``rows`` elements each (one K and one V
    scale per cache row; a (2, rows) tensor is such a pair).  Returns
    (ks, vs), or () without scales."""
    if scales is None:
        _check(q.dtype == k.dtype == v.dtype, lambda: f"dtypes {q.dtype}, {k.dtype}, {v.dtype} differ", what)
        return ()
    _check(k.dtype == v.dtype == torch.int8, lambda: f"scales come with an int8 cache, got {k.dtype}, {v.dtype}",
           what)
    _check(q.dtype in (torch.float32, torch.bfloat16), lambda: f"q must be f32 or bf16, got {q.dtype}", what)
    _check(len(scales) == 2 and all(s.dtype == torch.float32 and s.numel() == rows for s in scales),
           lambda: f"scales must be two f32 tensors of {rows} rows, got {[(tuple(s.shape), s.dtype) for s in scales]}",
           what)
    return tuple(scales)


def _scale_ptrs(kvs) -> tuple:
    if not kvs:
        return ctypes.c_void_p(None), ctypes.c_void_p(None)
    return ptr(kvs[0]), ptr(kvs[1])


def _control_words(B: int, T: int, dev, anc_words, base):
    """The chain defaults: all-ones words make the ancestor test vacuous.
    Only the plain versions need them as tensors: the kernels read a null
    pointer as these defaults, so a launch allocates nothing for them."""
    if anc_words is None:
        anc_words = torch.full((T,), -1, dtype=torch.int32, device=dev)
    if base is None:
        base = torch.zeros((B,), dtype=torch.int32, device=dev)
    return anc_words, base


# kernels 1 and 5 cut the row capacity S into chunks of this many rows and
# give each (kv head, token, sequence) up to DECODE_MAX_SPLITS blocks of them
# (flash_decode.cu's CHUNK and MAX_SPLITS: the C entries refuse a split count
# made from others)
DECODE_CHUNK = 64
DECODE_MAX_SPLITS = 32
# the head dims kernels 1, 5, 6 and 7 are built for: the powers of two, and
# 96 (Phi-3-Vision) and 160 (StableLM-12B)
_HEAD_DIMS = (16, 32, 64, 96, 128, 160, 256)
# the C signatures of repro_flash_decode and (one more pointer, the table,
# and one more int) repro_flash_decode_paged
_DECODE_ARGTYPES = [[ctypes.c_int] * 2 + [ctypes.c_void_p] * (10 + paged) + [ctypes.c_int] * (6 + paged)
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p] for paged in (0, 1)]


def decode_splits(S: int) -> int:
    """Splits per (kv head, token, sequence) of the contiguous and paged
    launches over a row capacity of ``S``: one per :data:`DECODE_CHUNK` rows,
    at most :data:`DECODE_MAX_SPLITS` (past that a split walks several
    chunks).  The count depends on shapes alone, never on the lengths (which
    stay on the device)."""
    return min(-(-int(S) // DECODE_CHUNK), DECODE_MAX_SPLITS)


def _check_words(words, dev, what: str) -> None:
    """Each (name, tensor or None, count) a ``(count,)`` int32 tensor on ``dev``."""
    for name, t, n in words:
        if t is not None:
            _check(t.dtype == torch.int32 and t.numel() == n and t.device == dev,
                   lambda: f"{name} must be ({n},) int32 on {dev}", what)


def _launch_decode(symbol: str, q, k, v, kvs, lengths, table, anc_words, base, dims: tuple, S: int, nkv: int,
                   what: str) -> torch.Tensor:
    """One launch of kernel 1 (``repro_flash_decode``, ``table`` None,
    ``dims`` (S,)) or 5 (``repro_flash_decode_paged``, ``dims`` (mp, ps))."""
    B, T, nq, hd = q.shape
    _check(hd in _HEAD_DIMS, lambda: f"head_dim {hd} not in {_HEAD_DIMS}", what)
    _check(all(t is None or t.is_contiguous() for t in (q, k, v, *kvs, lengths, table, anc_words, base)),
           "tensors must be contiguous", what)
    _check(q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
           "q, k and v must be 16-byte aligned", what)
    nsplit = decode_splits(S)
    out = torch.empty_like(q)
    part = torch.empty((B * T * nq * nsplit * (hd + 2),), dtype=torch.float32, device=q.device) if nsplit > 1 else None
    head = () if table is None else (table.data_ptr(),)
    fn = function("flash_decode", symbol, _DECODE_ARGTYPES[len(head)])
    ptrs = [None if t is None else t.data_ptr() for t in (*(kvs or (None, None)), out, part, lengths)]
    rc = fn(dtype_code(q.dtype), dtype_code(k.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, *head,
            None if anc_words is None else anc_words.data_ptr(), None if base is None else base.data_ptr(),
            B, T, *dims, nq, nkv, hd, 1.0 / math.sqrt(hd), nsplit, stream_of(q))
    check_launch(rc, what)
    return out


def flash_decode_kernel(
    q: torch.Tensor,        # (B, T, nq, hd)
    k: torch.Tensor,        # (B, S, nkv, hd) cache buffer, model layout
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B*T,) int32 valid prefix length per token
    anc_words: Optional[torch.Tensor] = None,  # (T,) int32 ancestor bitmasks
    base: Optional[torch.Tensor] = None,       # (B,) int32 committed-prefix length
    scales=None,  # (ks, vs), B*S f32 each: per-row K/V scales of an int8 cache
) -> torch.Tensor:
    """Vector-steered decode attention; (B, T, nq, hd) in q's type.  On the
    card one call is the :func:`decode_splits` launch and, with more than
    one split, their merge into an f32 scratch allocated here, counted
    once."""
    what = "flash_decode"
    B, T, nq, hd = q.shape
    _check(k.ndim == 4 and k.shape[0] == B and k.shape[3] == hd, lambda: f"k shape {tuple(k.shape)}", what)
    _check(v.shape == k.shape, lambda: f"v shape {tuple(v.shape)} != k shape {tuple(k.shape)}", what)
    S, nkv = k.shape[1], k.shape[2]
    _check(nq % nkv == 0, lambda: f"{nq} query heads not a multiple of {nkv} kv heads", what)
    kvs = _check_types(q, k, v, scales, B * S, what)
    dev = q.device
    _check(k.device == dev and v.device == dev and all(t.device == dev for t in kvs), "tensors on different devices",
           what)
    _check_words((("lengths", lengths, B * T), ("anc_words", anc_words, T), ("base", base, B)), dev, what)
    if dev.type == "cpu":
        return ref.flash_decode(q, k, v, lengths, *_control_words(B, T, dev, anc_words, base), scales)
    _check(dev.type == "cuda", lambda: f"unsupported device {dev}", what)
    out = _launch_decode("repro_flash_decode", q, k, v, kvs, lengths, None, anc_words, base, (S,), S, nkv, what)
    count_launch(flash_decode_kernel, int8=scales is not None)
    return out


flash_decode_kernel.launches = 0
flash_decode_kernel.int8_launches = 0


def flash_decode_paged_kernel(
    q: torch.Tensor,        # (B, T, nq, hd)
    pool_k: torch.Tensor,   # (R, nkv, hd) flat page pool, read in place
    pool_v: torch.Tensor,
    lengths: torch.Tensor,  # (B*T,) int32 valid prefix length per token
    table: torch.Tensor,    # (B*mp,) int32 block tables (-1 = unallocated)
    anc_words: Optional[torch.Tensor] = None,  # (T,) int32 ancestor bitmasks
    base: Optional[torch.Tensor] = None,       # (B,) int32 committed-prefix length
    scales=None,  # (ks, vs), R f32 each: per-pool-row K/V scales of an int8 pool
    *,
    page_size: int,
) -> torch.Tensor:
    """Paged decode attention: :func:`flash_decode_kernel`'s math with
    logical row ``p`` of sequence ``b`` read from pool row
    ``max(table[b*mp + p // ps], 0) * ps + p % ps``; (B, T, nq, hd) in q's
    type.  The row capacity is ``mp * page_size``, which sets the split.
    Table entries must name pages of the pool: they are not checked against
    it on the card (that would cost a host sync per launch)."""
    what = "flash_decode_paged"
    B, T, nq, hd = q.shape
    _check(pool_k.ndim == 3 and pool_k.shape[2] == hd, lambda: f"pool shape {tuple(pool_k.shape)}", what)
    _check(pool_v.shape == pool_k.shape, lambda: f"pool_v shape {tuple(pool_v.shape)} != {tuple(pool_k.shape)}", what)
    nkv = pool_k.shape[1]
    _check(nq % nkv == 0, lambda: f"{nq} query heads not a multiple of {nkv} kv heads", what)
    kvs = _check_types(q, pool_k, pool_v, scales, pool_k.shape[0], what)
    _check(page_size > 0 and table.numel() % B == 0 and table.numel() > 0, "table must be (B*max_pages,)", what)
    mp = table.numel() // B
    dev = q.device
    _check(pool_k.device == dev and pool_v.device == dev and all(t.device == dev for t in kvs),
           "tensors on different devices", what)
    _check_words((("lengths", lengths, B * T), ("table", table, B * mp), ("anc_words", anc_words, T),
                  ("base", base, B)), dev, what)
    if dev.type == "cpu":
        return ref.flash_decode_paged(q, pool_k, pool_v, lengths, table, *_control_words(B, T, dev, anc_words, base),
                                      page_size, scales)
    _check(dev.type == "cuda", lambda: f"unsupported device {dev}", what)
    out = _launch_decode("repro_flash_decode_paged", q, pool_k, pool_v, kvs, lengths, table, anc_words, base,
                         (mp, page_size), mp * page_size, nkv, what)
    count_launch(flash_decode_paged_kernel, int8=scales is not None)
    return out


flash_decode_paged_kernel.launches = 0
flash_decode_paged_kernel.int8_launches = 0


def flash_decode(
    q: torch.Tensor,   # (B, T, nq, hd) model layout
    k: torch.Tensor,   # (B, S, nkv, hd) cache buffer already holding this launch's K
    v: torch.Tensor,
    cache_index,       # scalar | (B,) | (B, T) token position(s)
    *,
    ancestors: Optional[torch.Tensor] = None,
    base: Optional[torch.Tensor] = None,
    scales=None,  # (2, B, S) f32 per-row K/V scales, or their (ks, vs) pair (int8 cache)
) -> torch.Tensor:
    """Multi-token attention over each token's valid cache prefix: token
    (b, t) attends to positions [0, index(b, t)]; with ``ancestors``/``base``
    draft rows are further masked by the tree's ancestor words."""
    B, T = q.shape[:2]
    lengths = _as_length_vector(cache_index, B, T, q.device)
    return flash_decode_kernel(q, k, v, lengths, ancestors, base, scales)


def flash_decode_paged(
    q: torch.Tensor,   # (B, T, nq, hd) model layout
    k: torch.Tensor,   # (R, nkv, hd) flat page pool already holding this launch's K
    v: torch.Tensor,
    cache_index,       # scalar | (B,) | (B, T) token position(s)
    pages: torch.Tensor,  # (B, max_pages) int32 block tables (-1 = unallocated)
    *,
    page_size: int,
    ancestors: Optional[torch.Tensor] = None,
    base: Optional[torch.Tensor] = None,
    scales=None,  # (2, R) f32 per-pool-row K/V scales, or their (ks, vs) pair (int8 pool)
) -> torch.Tensor:
    """:func:`flash_decode` against a flat page pool addressed through
    per-slot block tables: the pool row backing position ``pos`` of slot
    ``b`` is ``pages[b, pos // page_size] * page_size + pos % page_size``.
    With the identity table the result is bitwise :func:`flash_decode`'s."""
    B, T = q.shape[:2]
    lengths = _as_length_vector(cache_index, B, T, q.device)
    table = pages.reshape(-1).to(device=q.device, dtype=torch.int32)
    return flash_decode_paged_kernel(q, k, v, lengths, table, ancestors, base, scales, page_size=page_size)


# kernel 6 splits each token's visible run into chunks of this many rows,
# one block each, and merges the chunks' partial softmaxes in a second launch
# (flash_decode.cu's CHUNK: the C entry refuses a split count made from another)
WINDOW_CHUNK = 64


def window_splits(limit: int) -> int:
    """Splits per token of the window launch: ``ceil(limit / WINDOW_CHUNK)``.
    A token's visible run is at most ``limit`` rows, so this many chunks
    cover it; the count depends on shapes alone, never on the positions
    (which stay on the device)."""
    return -(-int(limit) // WINDOW_CHUNK)


def flash_decode_window_kernel(
    q: torch.Tensor,          # (B, T, nq, hd)
    k: torch.Tensor,          # (B, W, nkv, hd) rolling buffer, slot = position % W
    v: torch.Tensor,
    positions: torch.Tensor,  # (B*T,) int32 absolute position per token
    scales=None,  # (ks, vs), B*W f32 each: per-slot K/V scales of an int8 buffer
    *,
    window: int,
) -> torch.Tensor:
    """Window-steered decode attention over a rolling buffer: token (b, t) at
    ``pos = positions[b*T + t]`` sees positions in ``(pos - min(window, W), pos]``
    whose slot still holds them after the launch's last write (position
    ``positions[b*T + T - 1]``); (B, T, nq, hd) in q's type.  Positions must
    be nonnegative and consecutive in t; they are not checked on the card
    (that would cost a host sync per launch).  On the card one call is two
    launches (the :data:`WINDOW_CHUNK`-row splits, then their merge into an
    f32 scratch allocated here), counted once."""
    what = "flash_decode_window"
    B, T, nq, hd = q.shape
    _check(k.ndim == 4 and k.shape[0] == B and k.shape[3] == hd, f"k shape {tuple(k.shape)}", what)
    _check(v.shape == k.shape, f"v shape {tuple(v.shape)} != k shape {tuple(k.shape)}", what)
    W, nkv = k.shape[1], k.shape[2]
    _check(nq % nkv == 0, f"{nq} query heads not a multiple of {nkv} kv heads", what)
    kvs = _check_types(q, k, v, scales, B * W, what)
    _check(T <= W, f"a launch of {T} tokens would overwrite its own slots of a {W}-slot buffer", what)
    _check(window > 0, f"window must be positive, got {window}", what)
    _check(positions.dtype == torch.int32 and positions.numel() == B * T, f"positions must be ({B * T},) int32", what)
    dev = q.device
    _check(all(t.device == dev for t in (k, v, positions, *kvs)), "tensors on different devices", what)
    limit = min(int(window), W)
    if dev.type == "cpu":
        return ref.flash_decode_window(q, k, v, positions, limit, scales)
    _check(dev.type == "cuda", f"unsupported device {dev}", what)
    _check(hd in _HEAD_DIMS, f"head_dim {hd} not in {_HEAD_DIMS}", what)
    _check(all(t.is_contiguous() for t in (q, k, v, positions, *kvs)), "tensors must be contiguous", what)
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), "q, k and v must be 16-byte aligned", what)
    fn = function(
        "flash_decode", "repro_flash_decode_window",
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_int, ctypes.c_void_p],
    )
    nsplit = window_splits(limit)
    out = torch.empty_like(q)
    part = torch.empty((B * T * nq * nsplit * (hd + 2),), dtype=torch.float32, device=dev)
    rc = fn(
        dtype_code(q.dtype), dtype_code(k.dtype), ptr(q), ptr(k), ptr(v), *_scale_ptrs(kvs), ptr(out), ptr(part),
        ptr(positions), B, T, W, nq, nkv, hd, limit, 1.0 / math.sqrt(hd), nsplit, stream_of(q),
    )
    check_launch(rc, what)
    count_launch(flash_decode_window_kernel, int8=scales is not None)
    return out


flash_decode_window_kernel.launches = 0
flash_decode_window_kernel.int8_launches = 0


def flash_decode_window(
    q: torch.Tensor,   # (B, T, nq, hd) model layout
    k: torch.Tensor,   # (B, W, nkv, hd) rolling buffer already holding this launch's K
    v: torch.Tensor,
    cache_index,       # scalar | (B,) position of token (b, 0)
    *,
    window: int,
    scales=None,  # (2, B, W) f32 per-slot K/V scales, or their (ks, vs) pair (int8 buffer)
) -> torch.Tensor:
    """Window-steered attention over a rolling cache: token (b, t) at
    absolute position ``index(b) + t`` sees positions in
    ``(pos - window, pos]`` through the wrap point."""
    B, T = q.shape[:2]
    positions = _as_length_vector(cache_index, B, T, q.device) - 1
    return flash_decode_window_kernel(q, k, v, positions, scales, window=window)


_FA_TC_HEAD_DIMS = (64, 96, 128, 160, 256)
_FA_MAX_GROUP = 64
# the C signatures of repro_flash_attention_tc and (a dtype code first)
# repro_flash_attention
_FA_TC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_FA_ARGTYPES = [ctypes.c_int] + _FA_TC_ARGTYPES


def flash_attention_path(dtype: torch.dtype, hd: int) -> str:
    """Which build of kernel 7 a launch takes, from its dtype and head dim
    alone: ``"tensor_cores"`` (bf16 wgmma tiles fed by TMA) for bf16 at head
    dims 64, 96, 128, 160 and 256, every registered arch's prefill;
    ``"cuda_cores"`` (f32 products) for f32 at every head dim and for bf16
    at 16 and 32.  Raises ``ValueError`` for a head dim no build has."""
    _check(hd in _HEAD_DIMS, lambda: f"head_dim {hd} not in {_HEAD_DIMS}", "flash_attention")
    return "tensor_cores" if dtype == torch.bfloat16 and hd in _FA_TC_HEAD_DIMS else "cuda_cores"


def flash_attention_kernel(
    q: torch.Tensor,   # (B, Sq, nq, hd)
    k: torch.Tensor,   # (B, Skv, nkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Blocked causal / local-window GQA attention forward; (B, Sq, nq, hd)
    in q's type.  Query position i sees key j iff (not causal or j <= i) and
    (not window or i - j < window).  On the card the launch takes the path
    :func:`flash_attention_path` names."""
    _check_prefill(q, k, v, window, "flash_attention")
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    out = _launch_prefill(q, k, v, causal, window)
    flash_attention_kernel.launches += 1
    return out


def _check_prefill(q, k, v, window: int, what: str) -> None:
    """The shape, type and device contract of kernel 7 and its backward."""
    B, Sq, nq, hd = q.shape
    _check(k.ndim == 4 and k.shape[0] == B and k.shape[3] == hd, lambda: f"k shape {tuple(k.shape)}", what)
    _check(v.shape == k.shape, lambda: f"v shape {tuple(v.shape)} != k shape {tuple(k.shape)}", what)
    nkv = k.shape[2]
    _check(nq % nkv == 0, lambda: f"{nq} query heads not a multiple of {nkv} kv heads", what)
    _check(q.dtype == k.dtype == v.dtype, lambda: f"dtypes {q.dtype}, {k.dtype}, {v.dtype} differ", what)
    _check(window >= 0, lambda: f"window must be >= 0, got {window}", what)
    dev = q.device
    _check(k.device == dev and v.device == dev, "tensors on different devices", what)
    _check(dev.type in ("cpu", "cuda"), lambda: f"unsupported device {dev}", what)


def _launch_prefill(q, k, v, causal: bool, window: int, lse: bool = False):
    """Kernel 7's launch checks, then its launch on the build
    :func:`flash_attention_path` names (``repro_flash_attention_tc`` or
    ``repro_flash_attention``, with ``lse`` their ``_lse`` instantiations,
    which also return each row's log-sum-exp); a refused launch raises,
    nothing falls back.  Returns out, or with ``lse`` (out, lse)."""
    what = "flash_attention"
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    path = flash_attention_path(q.dtype, hd)
    _check(nq // nkv <= _FA_MAX_GROUP, lambda: f"a query group of {nq // nkv} heads exceeds {_FA_MAX_GROUP}", what)
    _check(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(), "tensors must be contiguous", what)
    out = torch.empty_like(q)
    lse_out = torch.empty((B, Sq, nq), dtype=torch.float32, device=q.device) if lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()) + ((lse_out.data_ptr(),) if lse else ())
    shape = (B, Sq, Skv, nq, nkv, hd, int(causal), int(window), 1.0 / math.sqrt(hd), stream_of(q))
    suffix = "_lse" if lse else ""
    if path == "tensor_cores":
        _check((q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0, "q, k and v must be 16-byte aligned", what)
        rc = function("flash_attention", "repro_flash_attention_tc" + suffix,
                      _FA_TC_LSE_ARGTYPES if lse else _FA_TC_ARGTYPES)(*ptrs, *shape)
    else:
        rc = function("flash_attention", "repro_flash_attention" + suffix, _FA_LSE_ARGTYPES if lse else _FA_ARGTYPES)(
            dtype_code(q.dtype), *ptrs, *shape)
    check_launch(rc, what)
    return (out, lse_out) if lse else out


flash_attention_kernel.launches = 0


# the C signatures of repro_flash_attention_tc_lse and (a dtype code first)
# repro_flash_attention_lse: the serving ones with the lse pointer after out;
# and of repro_flash_attention_bwd
_FA_TC_LSE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_FA_LSE_ARGTYPES = [ctypes.c_int] + _FA_TC_LSE_ARGTYPES
_FA_BWD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
# and of repro_flash_attention_bwd_tc: the same without the dtype code
_FA_BWD_TC_ARGTYPES = _FA_BWD_ARGTYPES[1:]
_FA_BWD_TC_HEAD_DIMS = (64, 96, 128, 160, 256)


def flash_attention_bwd_path(dtype: torch.dtype, hd: int) -> str:
    """Which build of kernel 7's backward a launch takes, from its dtype and
    head dim alone: ``"tensor_cores"`` (bf16 wgmma tiles fed by TMA, four
    launches) for bf16 at head dims 64, 96, 128, 160 and 256, every
    registered arch that trains; ``"cuda_cores"`` (f32 products, three
    launches) for f32 at every head dim and for bf16 at 16 and 32.  Raises
    ``ValueError`` for a head dim or a dtype no build has."""
    what = "flash_attention_bwd"
    _check(hd in _HEAD_DIMS, lambda: f"head_dim {hd} not in {_HEAD_DIMS}", what)
    _check(dtype in (torch.float32, torch.bfloat16), lambda: f"dtype {dtype} is neither float32 nor bfloat16", what)
    return "tensor_cores" if dtype == torch.bfloat16 and hd in _FA_BWD_TC_HEAD_DIMS else "cuda_cores"


def bwd_scratch_floats(path: str, B: int, Sq: int, Skv: int, nq: int, hd: int) -> int:
    """f32 scratch of a backward launch: D (B, Sq, nq) on the CUDA cores; on
    the tensor cores lse in base 2 and D per head over positions padded to
    a multiple of 64, (B, nq, Sp) each, then the per-head partial dK and dV,
    (B, Skv, nq, hd) each (``repro_flash_attention_bwd_tc``'s layout, the
    same at every head dim: at hd 256 one warpgroup writes a head's partial
    dV and another its partial dK)."""
    if path == "cuda_cores":
        return B * Sq * nq
    Sp = -(-Sq // 64) * 64
    return 2 * B * nq * Sp + 2 * B * Skv * nq * hd


def flash_attention_lse_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                               window: int = 0):
    """Kernel 7's training forward: ``(out, lse)``, ``out`` as
    :func:`flash_attention_kernel` computes it (bitwise, on the card: the
    LSE instantiation of the same build) and ``lse`` (B, Sq, nq) f32 each
    row's log-sum-exp of its scaled scores, +inf for a row that sees no
    key.  Counted as a launch of :func:`flash_attention_kernel`."""
    _check_prefill(q, k, v, window, "flash_attention")
    if q.device.type == "cpu":
        return ref.flash_attention_lse(q, k, v, causal=causal, window=window)
    out = _launch_prefill(q, k, v, causal, window, lse=True)
    flash_attention_kernel.launches += 1
    return out


def flash_attention_bwd_kernel(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0):
    """Kernel 7's backward (``csrc/flash_attention_bwd.cu``): ``(dq, dk,
    dv)`` in the inputs' type from the forward's ``out`` and ``lse`` and
    the output gradient ``dout`` (B, Sq, nq, hd).  On the card one call is
    the launches of the build :func:`flash_attention_bwd_path` names (three
    on the CUDA cores, four on the tensor cores, with an f32 scratch
    allocated here), counted once; on the CPU the plain version
    :func:`ref.flash_attention_bwd`."""
    what = "flash_attention_bwd"
    _check_prefill(q, k, v, window, what)
    B, Sq, nq, hd = q.shape
    _check(out.shape == q.shape and dout.shape == q.shape and out.dtype == q.dtype and dout.dtype == q.dtype,
           lambda: f"out {tuple(out.shape)} {out.dtype} and dout {tuple(dout.shape)} {dout.dtype} must match q", what)
    _check(lse.shape == (B, Sq, nq) and lse.dtype == torch.float32, lambda: f"lse must be ({B}, {Sq}, {nq}) f32", what)
    _check(all(t.device == q.device for t in (out, lse, dout)), "tensors on different devices", what)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)
    grads = _launch_bwd(q, k, v, out, lse, dout, causal, window)
    flash_attention_bwd_kernel.launches += 1
    return grads


def _launch_bwd(q, k, v, out, lse, dout, causal: bool, window: int):
    """Kernel 7's backward's launch checks, then its launches on the build
    :func:`flash_attention_bwd_path` names (``repro_flash_attention_bwd_tc``
    or ``repro_flash_attention_bwd``); a refused launch raises, nothing
    falls back.  Returns (dq, dk, dv)."""
    what = "flash_attention_bwd"
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    path = flash_attention_bwd_path(q.dtype, hd)
    _check(nq // nkv <= _FA_MAX_GROUP, lambda: f"a query group of {nq // nkv} heads exceeds {_FA_MAX_GROUP}", what)
    _check(all(t.is_contiguous() for t in (q, k, v, out, lse, dout)), "tensors must be contiguous", what)
    if path == "tensor_cores":
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out, dout)),
               "q, k, v, out and dout must be 16-byte aligned", what)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty((bwd_scratch_floats(path, B, Sq, Skv, nq, hd),), dtype=torch.float32, device=q.device)
    ptrs = tuple(t.data_ptr() for t in (q, k, v, out, dout, lse, scratch, dq, dk, dv))
    shape = (B, Sq, Skv, nq, nkv, hd, int(causal), int(window), 1.0 / math.sqrt(hd), stream_of(q))
    if path == "tensor_cores":
        rc = function("flash_attention_bwd", "repro_flash_attention_bwd_tc", _FA_BWD_TC_ARGTYPES)(*ptrs, *shape)
    else:
        rc = function("flash_attention_bwd", "repro_flash_attention_bwd", _FA_BWD_ARGTYPES)(
            dtype_code(q.dtype), *ptrs, *shape)
    check_launch(rc, what)
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0


class _FlashAttentionTrain(torch.autograd.Function):
    """Kernel 7 with its gradient: the forward saves q, k, v, out and lse,
    the backward launches :func:`flash_attention_bwd_kernel` (on the CPU
    both halves are the plain versions; on the card neither ever is)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_lse_kernel(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
                                                window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Differentiable prefill attention in the model's layout (the training
    forward): :func:`flash_attention`'s output, with the gradient of q, k
    and v computed by kernel 7's backward."""
    return _FlashAttentionTrain.apply(q.contiguous(), k.contiguous(), v.contiguous(), bool(causal), int(window))


def flash_attention(
    q: torch.Tensor,   # (B, Sq, nq, hd) model layout
    k: torch.Tensor,   # (B, Skv, nkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Prefill attention in the model's layout (the reference's
    ``flash_attention/ops.flash_attention``): q, k, v are made contiguous
    (a no-op for the model's projections) and handed to the kernel."""
    return flash_attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, window=window)
