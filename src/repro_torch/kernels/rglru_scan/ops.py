"""RG-LRU scan wrapper (port of ``repro/kernels/rglru_scan/ops.py``).

:func:`rglru_scan` takes the plain version (:mod:`.ref`) on CPU tensors and
launches ``csrc/rglru_scan.cu`` on ``cuda`` tensors, or raises.  Unlike the
TPU wrapper it pads nothing: the kernel takes any T and masks the last
chunk and the last tile of channels itself.

The kernel is a chunked scan over T in one launch: blocks of ``CHUNK``
steps, each split into segments of ``SEGMENT`` steps (one warp each).  Per
chunk it folds the segments' aggregates (the product of a, the scan from 0)
in ascending order into the chunk's; the carry into chunk c is h0 folded
with chunks 0..c-1's aggregates in ascending order; each segment then walks
again from the chunk's carry folded with the segments before it.  That
order depends on the shapes alone, never on the build or on timing
(``tests/test_torch_rglru_chunks.py`` models it in torch).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.rglru_scan import ref

CHUNK = 128    # steps a block takes (csrc/rglru_scan.cu CHUNK)
SEGMENT = 8    # steps each of its warps walks (SEG)
LANE_CHANNELS = 4  # channels a lane on the "vector" build; a block's tile is 32 lanes

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rglru_scan: {msg}")


def rglru_scan_path(W: int, aligned: bool) -> str:
    """The build a launch takes: ``"vector"`` (``LANE_CHANNELS`` channels a
    lane: 16 bytes of f32 a and of b a step, 8 of bf16) when W is a multiple
    of them and a and b start aligned to them, else ``"scalar"`` (one
    channel a lane).  Both compute the same sums in the same order."""
    return "vector" if aligned and W % LANE_CHANNELS == 0 else "scalar"


def scratch_words(B: int, T: int, W: int, vec: int) -> int:
    """4-byte words of the launch's scratch: the ticket and one flag a
    (batch row, chunk, tile), padded to 16 bytes, then each chunk's
    aggregate (A and H, 2 W floats) a batch row."""
    nchunks, ntiles = -(-T // CHUNK), -(-W // (32 * vec))
    return (1 + B * nchunks * ntiles + 3) // 4 * 4 + B * nchunks * 2 * W


def rglru_scan(
    a: torch.Tensor,                   # (B, T, W) f32 or bf16
    b: torch.Tensor,                   # (B, T, W), a's type
    h0: Optional[torch.Tensor] = None,  # (B, W); None = zeros
) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1; (B, T, W) f32."""
    _check(a.ndim == 3 and b.shape == a.shape, f"a {tuple(a.shape)} and b {tuple(b.shape)} must be (B, T, W)")
    _check(a.dtype == b.dtype, f"a and b dtypes {a.dtype}, {b.dtype} differ")
    B, T, W = a.shape
    dev = a.device
    _check(h0 is None or h0.shape == (B, W), f"h0 shape {None if h0 is None else tuple(h0.shape)} != {(B, W)}")
    _check(b.device == dev and (h0 is None or h0.device == dev), "tensors on different devices")
    if dev.type == "cpu":
        if h0 is None:
            h0 = torch.zeros((B, W), dtype=torch.float32, device=dev)
        return ref.rglru_scan(a, b, h0)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    if h0 is not None:
        h0 = h0.to(torch.float32)
    _check(all(t.is_contiguous() for t in (a, b) + (() if h0 is None else (h0,))), "tensors must be contiguous")
    align = LANE_CHANNELS * a.element_size()
    path = rglru_scan_path(W, a.data_ptr() % align == 0 and b.data_ptr() % align == 0)
    vec = LANE_CHANNELS if path == "vector" else 1
    fn = function("rglru_scan", "repro_rglru_scan", _ARGTYPES)
    out = torch.empty((B, T, W), dtype=torch.float32, device=dev)
    scratch = torch.empty((scratch_words(B, T, W, vec),), dtype=torch.int32, device=dev)
    rc = fn(dtype_code(a.dtype), ptr(a), ptr(b), None if h0 is None else ptr(h0), ptr(out), ptr(scratch),
            B, T, W, vec, stream_of(a))
    check_launch(rc, "rglru_scan")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
