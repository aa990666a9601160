"""RG-LRU scan wrapper (port of ``repro/kernels/rglru_scan/ops.py``).

:func:`rglru_scan` takes the plain version (:mod:`.ref`) on CPU tensors and
launches ``csrc/rglru_scan.cu`` on ``cuda`` tensors, or raises.  Unlike the
TPU wrapper it pads nothing: the kernel walks any T and masks the last
block of channels itself.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.rglru_scan import ref


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rglru_scan: {msg}")


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
    if h0 is None:
        h0 = torch.zeros((B, W), dtype=torch.float32, device=dev)
    _check(h0.shape == (B, W), f"h0 shape {tuple(h0.shape)} != {(B, W)}")
    _check(b.device == dev and h0.device == dev, "tensors on different devices")
    if dev.type == "cpu":
        return ref.rglru_scan(a, b, h0)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    h0 = h0.to(torch.float32)
    _check(all(t.is_contiguous() for t in (a, b, h0)), "tensors must be contiguous")
    fn = function("rglru_scan", "repro_rglru_scan", [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])
    out = torch.empty((B, T, W), dtype=torch.float32, device=dev)
    rc = fn(dtype_code(a.dtype), ptr(a), ptr(b), ptr(h0), ptr(out), B, T, W, stream_of(a))
    check_launch(rc, "rglru_scan")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
