"""Chunked SSD scan wrapper (port of ``repro/kernels/ssd_scan/ops.py``).

:func:`ssd_scan` takes the plain version (:mod:`.ref`) on CPU tensors and
launches ``csrc/ssd_scan.cu`` on ``cuda`` tensors, or raises.  As in the
reference wrapper, the chunk-local inclusive cumsum of ``dt * a`` is
computed here, outside the kernel.  The kernel walks chunks of
``min(chunk, T, QMAX)`` steps (the same function as ``chunk`` summed in
another order), reads x, B and C in place through their batch and time
strides (views of the model's projection need no copy), and masks a
ragged tail itself: nothing is padded.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ref

QMAX = 64   # the kernel's largest chunk: its shared-memory tiles are QMAX rows
NMAX = 128  # the kernel's largest state size
PMAX = 64   # the kernel's largest head dim


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_scan: {msg}")


def chunk_cumsum(dt: torch.Tensor, a: torch.Tensor, q: int) -> torch.Tensor:
    """(B, T, H) f32: the inclusive cumsum of ``dt * a`` within chunks of ``q`` steps."""
    B, T, H = dt.shape
    pad = (-T) % q
    l = F.pad(dt.to(torch.float32) * a.to(torch.float32), (0, 0, 0, pad))
    return torch.cumsum(l.reshape(B, -1, q, H), dim=2).reshape(B, T + pad, H)[:, :T].contiguous()


def _inner_contiguous(t: torch.Tensor, strides) -> torch.Tensor:
    """``t`` if its trailing strides are ``strides``, else a contiguous copy."""
    return t if tuple(t.stride()[-len(strides):]) == tuple(strides) else t.contiguous()


def ssd_scan(
    x: torch.Tensor,    # (B, T, H, P)
    dt: torch.Tensor,   # (B, T, H) post-softplus
    a: torch.Tensor,    # (H,) negative
    bm: torch.Tensor,   # (B, T, N)
    cm: torch.Tensor,   # (B, T, N)
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P); None = zeros
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, P) f32, final state (B, H, N, P) f32)."""
    _check(x.ndim == 4, f"x {tuple(x.shape)} must be (B, T, H, P)")
    B, T, H, P = x.shape
    _check(T > 0 and chunk > 0, f"T {T} and chunk {chunk} must be positive")
    _check(dt.shape == (B, T, H) and a.shape == (H,), f"dt {tuple(dt.shape)}, a {tuple(a.shape)}")
    _check(bm.ndim == 3 and bm.shape[:2] == (B, T) and cm.shape == bm.shape,
           f"bm {tuple(bm.shape)} and cm {tuple(cm.shape)} must be (B, T, N)")
    N = bm.shape[-1]
    _check(h0 is None or h0.shape == (B, H, N, P), f"h0 shape {tuple(h0.shape) if h0 is not None else None}")
    dev = x.device
    _check(all(t.device == dev for t in (dt, a, bm, cm) + ((h0,) if h0 is not None else ())),
           "tensors on different devices")
    if dev.type == "cpu":
        return ref.ssd_chunked(x, dt, a, bm, cm, chunk, h0)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(x.dtype == bm.dtype == cm.dtype, f"x, bm, cm dtypes {x.dtype}, {bm.dtype}, {cm.dtype} differ")
    _check(P % 4 == 0 and P <= PMAX and N % 4 == 0 and N <= NMAX,
           f"head dim {P} and state {N} must be multiples of 4 up to {PMAX} and {NMAX}")
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    q = min(chunk, T, QMAX)
    cum = chunk_cumsum(dt, a, q)
    dt = dt.to(torch.float32).contiguous()
    x = _inner_contiguous(x, (P, 1))
    bm, cm = _inner_contiguous(bm, (1,)), _inner_contiguous(cm, (1,))
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=dev)
    h_out = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    fn = function("ssd_scan", "repro_ssd_scan",
                  [ctypes.c_int, vp, i64, i64, vp, vp, vp, i64, i64, vp, i64, i64, vp, vp, vp]
                  + [ctypes.c_int] * 6 + [vp])
    rc = fn(dtype_code(x.dtype), ptr(x), x.stride(0), x.stride(1), ptr(dt), ptr(cum),
            ptr(bm), bm.stride(0), bm.stride(1), ptr(cm), cm.stride(0), cm.stride(1),
            ptr(h0) if h0 is not None else vp(None), ptr(y), ptr(h_out), B, T, H, N, P, q, stream_of(x))
    check_launch(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_out


ssd_scan.launches = 0
