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

For training, :func:`rglru_scan_train` is the scan under an autograd
Function whose backward is :func:`rglru_scan_bwd`: the same kernel
instantiated over reversed time (the chunks and segments mirrored), one
launch after the flags' memset, writing the gates' gradients in its walk.
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
_BWD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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


def rglru_scan_bwd(
    a: torch.Tensor,                    # (B, T, W) f32 or bf16: the forward's gates
    h: torch.Tensor,                    # (B, T, W) f32: the forward's output
    g: torch.Tensor,                    # (B, T, W) f32: dL/dh
    h0: Optional[torch.Tensor] = None,  # (B, W) f32, or None (zeros)
):
    """Kernel 12's backward (12_bwd): ``(da, db, dh0)`` with delta_t = g_t
    + a_{t+1} delta_{t+1}, db_t = delta_t, da_t = delta_t h_{t-1} (h0, or
    0, before the first step), in a's type, and dh0 = a_0 delta_0 (f32;
    None without h0).  On the card one launch of the reversed instantiation
    after its flags' memset, over the forward's scratch layout, counted
    once."""
    _check(a.ndim == 3 and h.shape == a.shape and g.shape == a.shape,
           f"a {tuple(a.shape)}, h {tuple(h.shape)} and g {tuple(g.shape)} must be (B, T, W)")
    _check(h.dtype == g.dtype == torch.float32, "h and g must be f32")
    B, T, W = a.shape
    dev = a.device
    _check(h0 is None or h0.shape == (B, W), f"h0 shape {None if h0 is None else tuple(h0.shape)} != {(B, W)}")
    _check(all(t.device == dev for t in (h, g) + (() if h0 is None else (h0,))), "tensors on different devices")
    if dev.type == "cpu":
        return ref.rglru_scan_bwd(a, h, g, h0)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(all(t.is_contiguous() for t in (a, h, g)), "tensors must be contiguous")
    out = _launch_bwd(a, h, g, None if h0 is None else h0.to(torch.float32).contiguous())
    rglru_scan_bwd.launches += 1
    return out


def _launch_bwd(a, h, g, h0):
    """12_bwd's C entry on the wrapper's checked tensors (h0 f32 or
    None), its outputs and scratch allocated here; the build as
    :func:`rglru_scan_path` names it, every operand's alignment counted; a
    refused launch raises."""
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    B, T, W = a.shape
    dev = a.device
    aligned = a.data_ptr() % (LANE_CHANNELS * a.element_size()) == 0 and all(
        t.data_ptr() % (LANE_CHANNELS * 4) == 0 for t in (h, g) + (() if h0 is None else (h0,)))
    vec = LANE_CHANNELS if rglru_scan_path(W, aligned) == "vector" else 1
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty((B, W), dtype=torch.float32, device=dev)
    scratch = torch.empty((scratch_words(B, T, W, vec),), dtype=torch.int32, device=dev)
    rc = function("rglru_scan", "repro_rglru_scan_bwd", _BWD_ARGTYPES)(
        dtype_code(a.dtype), ptr(a), ptr(g), ptr(h), None if h0 is None else ptr(h0), ptr(da), ptr(db),
        None if dh0 is None else ptr(dh0), ptr(scratch), B, T, W, vec, stream_of(a))
    check_launch(rc, "rglru_scan_bwd")
    return da, db, dh0


rglru_scan_bwd.launches = 0


class _RglruScanTrain(torch.autograd.Function):
    """Kernel 12 with its gradient: the forward launches :func:`rglru_scan`
    and saves a and h, the backward launches :func:`rglru_scan_bwd` (on the
    CPU both are the plain versions; on the card neither ever is)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_bwd(a, h, g.contiguous(), h0)
        return da, db, None if dh0 is None else dh0.to(h0.dtype)


def rglru_scan_train(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable :func:`rglru_scan` (the training forward): (B, T, W)
    f32, with the gradient of a, b and h0 from kernel 12's backward."""
    return _RglruScanTrain.apply(a.contiguous(), b.contiguous(), h0)
