"""Chunked SSD scan wrapper (port of ``repro/kernels/ssd_scan/ops.py``).

:func:`ssd_scan` takes the plain version (:mod:`.ref`) on CPU tensors and
launches ``csrc/ssd_scan.cu`` on ``cuda`` tensors, or raises.  On the card
it takes one of two builds, named by :func:`ssd_scan_path`:

* tensor cores (bf16 x, B and C at P 64, N 128, read by TMA): chunks of
  ``TC_CHUNK`` steps split over blocks in three launches (chunk states,
  state passing, chunk outputs) that also compute the chunk-local cumsum
  of ``dt * a``; one f32 scratch holds what passes between them;
* CUDA cores (f32, and bf16 at any other shape or alignment): one block per
  (batch, head) walking chunks of ``min(chunk, T, QMAX)`` steps, with the
  cumsum computed here as in the reference wrapper.

Either way the function is the plain version's at ``chunk``, summed in
another order; x, B and C are read in place through their batch and time
strides (views of the model's projection need no copy), and a ragged tail
is masked in the kernel: nothing is padded.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ref

QMAX = 64   # the CUDA-core build's largest chunk: its shared-memory tiles are QMAX rows
NMAX = 128  # the CUDA-core build's largest state size
PMAX = 64   # the CUDA-core build's largest head dim
TC_CHUNK = 256  # the tensor-core build's chunk (Mamba-2's own)
TC_STATE = 128  # the tensor-core build's state size N
TC_HEAD_DIM = 64  # and head dim P


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_scan: {msg}")


def chunk_cumsum(dt: torch.Tensor, a: torch.Tensor, q: int) -> torch.Tensor:
    """(B, T, H) f32: the inclusive cumsum of ``dt * a`` within chunks of ``q`` steps."""
    B, T, H = dt.shape
    pad = (-T) % q
    l = F.pad(dt.to(torch.float32) * a.to(torch.float32), (0, 0, 0, pad))
    return torch.cumsum(l.reshape(B, -1, q, H), dim=2).reshape(B, T + pad, H)[:, :T].contiguous()


def ssd_scan_path(dtype: torch.dtype, N: int, P: int, aligned: bool) -> str:
    """Which build of kernel 11 a launch takes, from the dtype of x, B and C,
    the state size, the head dim and whether TMA can read them in place
    (``aligned``: unit inner strides, head stride P, batch and time strides
    multiples of 8 elements, 16-byte-aligned bases): ``"tensor_cores"``
    (bf16 at N 128, P 64) or ``"cuda_cores"`` (everything else)."""
    ok = dtype == torch.bfloat16 and N == TC_STATE and P == TC_HEAD_DIM and aligned
    return "tensor_cores" if ok else "cuda_cores"


def tma_ready(x: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor) -> bool:
    """x, B and C as TMA reads them in place: unit inner strides, x's head
    stride P, batch and time strides multiples of 8 elements, and 16-byte
    aligned bases."""
    P = x.shape[-1]
    outer = (x.stride(0), x.stride(1), bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1))
    return (x.stride(3) == 1 and x.stride(2) == P and bm.stride(2) == 1 and cm.stride(2) == 1
            and all(st > 0 and st % 8 == 0 for st in outer)
            and all(t.data_ptr() % 16 == 0 for t in (x, bm, cm)))


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
    """Returns (y (B, T, H, P) f32, final state (B, H, N, P) f32).  On the
    card the launch takes the build :func:`ssd_scan_path` names (three CUDA
    launches on tensor cores, one on CUDA cores; counted once)."""
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
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    dt = dt.to(torch.float32).contiguous()
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=dev)
    h_out = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    h0_ptr = ptr(h0) if h0 is not None else ctypes.c_void_p(None)
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    if ssd_scan_path(x.dtype, N, P, tma_ready(x, bm, cm)) == "tensor_cores":
        nc = -(-T // TC_CHUNK)
        scratch = torch.empty((B * nc * H * (2 * N * P + 2 * TC_CHUNK + 1),), dtype=torch.float32, device=dev)
        a = a.to(torch.float32).contiguous()
        fn = function("ssd_scan", "repro_ssd_scan_tc",
                      [vp, i64, i64, vp, vp, vp, i64, i64, vp, i64, i64, vp, vp, vp, vp] + [ctypes.c_int] * 5 + [vp])
        rc = fn(ptr(x), x.stride(0), x.stride(1), ptr(dt), ptr(a), ptr(bm), bm.stride(0), bm.stride(1),
                ptr(cm), cm.stride(0), cm.stride(1), h0_ptr, ptr(y), ptr(h_out), ptr(scratch), B, T, H, N, P,
                stream_of(x))
    else:
        _check(P % 4 == 0 and P <= PMAX and N % 4 == 0 and N <= NMAX,
               f"head dim {P} and state {N} must be multiples of 4 up to {PMAX} and {NMAX}")
        q = min(chunk, T, QMAX)
        cum = chunk_cumsum(dt, a, q)
        x = _inner_contiguous(x, (P, 1))
        bm, cm = _inner_contiguous(bm, (1,)), _inner_contiguous(cm, (1,))
        fn = function("ssd_scan", "repro_ssd_scan",
                      [ctypes.c_int, vp, i64, i64, vp, vp, vp, i64, i64, vp, i64, i64, vp, vp, vp]
                      + [ctypes.c_int] * 6 + [vp])
        rc = fn(dtype_code(x.dtype), ptr(x), x.stride(0), x.stride(1), ptr(dt), ptr(cum),
                ptr(bm), bm.stride(0), bm.stride(1), ptr(cm), cm.stride(0), cm.stride(1),
                h0_ptr, ptr(y), ptr(h_out), B, T, H, N, P, q, stream_of(x))
    check_launch(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, h_out


ssd_scan.launches = 0
