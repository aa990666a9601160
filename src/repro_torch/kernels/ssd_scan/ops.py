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

For training, :func:`ssd_scan_train` is the scan under an autograd
Function whose backward is :func:`ssd_scan_bwd` (11_bwd: no atomics, in
one of two builds named by :func:`ssd_scan_bwd_path`, each over chunks of
its own ``BWD_CHUNK`` steps; its plain version :func:`.ref.ssd_chunked_bwd`
on the CPU).
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
# the backward's chunk a build: the CUDA-core build's q x q tiles and a
# chunk's rows sit in shared memory (csrc/ssd_scan.cu bwd::Q); the
# tensor-core build takes the forward's chunk in row tiles of 64 (bwd_tc)
BWD_CHUNK = {"cuda_cores": 64, "tensor_cores": TC_CHUNK}
BWD_ROW_HEADS = 8  # heads a row block of the tensor-core backward: dB / dC's state terms summed over them
BWD_COL_HEADS = 8  # heads a column block: dCB summed over them


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


def ssd_scan_bwd_path(dtype: torch.dtype, N: int, P: int, aligned: bool) -> str:
    """Which build of 11_bwd a launch takes: ``"tensor_cores"`` (bf16 x, B
    and C at N 128, P 64 that TMA reads in place, ``aligned`` as
    :func:`tma_ready` says: ``wgmma`` over chunks of 256, the f32 operands
    as hi + lo bf16) or ``"cuda_cores"`` (f32, and bf16 at any other shape
    or alignment)."""
    ok = dtype == torch.bfloat16 and N == TC_STATE and P == TC_HEAD_DIM and aligned
    return "tensor_cores" if ok else "cuda_cores"


def _r64(n: int) -> int:
    return -(-n // 64) * 64


def bwd_scratch_floats(B: int, T: int, H: int, N: int, P: int, path: str) -> int:
    """f32 elements of 11_bwd's scratch on the build ``path`` names, at
    chunks of ``BWD_CHUNK[path]`` steps.

    CUDA cores: per (batch, chunk, head) the chunk's state and its
    gradient's input term (2 N P, then the entering states and the
    gradients of the states leaving), the chunk's decay and its share of da
    (2); per (batch, step, head) the head's share of dB and of dC (2 N).

    Tensor cores (``csrc/ssd_scan.cu`` ``bwd_tc::Scratch``, each region
    rounded up to 64 elements): per (batch, chunk, head) u the chunk state
    s, its cum and dt rows, its decay, r, the rows' cum in f64, the
    entering states and the leaving states' gradients as hi and lo bf16
    planes, the sums of g o hp; dx's state term (B T H P); dL/dw, the
    carried-in term's two shares, the column and row sums of M (u Q, 2 u
    Q, u Q, 4 u Q); the dCB tiles per 8 heads and summed (10 causal 64 x
    64 tile pairs a chunk); the dB and dC state terms per 8 heads (B T N
    each); da's share per (batch, chunk, head)."""
    Q = BWD_CHUNK[path]
    nc = -(-T // Q)
    u = B * nc * H
    if path == "cuda_cores":
        return u * (2 * N * P + 2) + 2 * B * T * H * N
    ngr, ngc = -(-H // BWD_ROW_HEADS), -(-H // BWD_COL_HEADS)
    tile, pairs = 64 * 64, 10
    regions = (u * N * P, 2 * u * Q, u, u * N * P, 2 * u * Q, u * N * P, u * N * P, u * (N * P // 1024),
               B * T * H * P, u * Q, 2 * u * Q, u * Q, 4 * u * Q, B * nc * ngc * pairs * tile,
               B * nc * pairs * tile, B * T * ngr * N, B * T * ngr * N, B * nc * H)
    return sum(_r64(n) for n in regions)


def ssd_scan_bwd(
    x: torch.Tensor,    # (B, T, H, P)
    dt: torch.Tensor,   # (B, T, H) post-softplus
    a: torch.Tensor,    # (H,) negative
    bm: torch.Tensor,   # (B, T, N)
    cm: torch.Tensor,   # (B, T, N)
    chunk: int,
    dy: torch.Tensor,   # (B, T, H, P) f32: dL/dy
    dh_final: Optional[torch.Tensor] = None,  # (B, H, N, P): dL/d(final state); None = zeros
    h0: Optional[torch.Tensor] = None,        # (B, H, N, P) or None (zeros)
):
    """Kernel 11's backward (11_bwd): ``(dx, ddt, da, dB, dC, dh0)`` of
    :func:`ssd_scan`, each in its input's type (dh0 f32, None without
    ``h0``).  On the card the build :func:`ssd_scan_bwd_path` names runs
    over one f32 scratch (:func:`bwd_scratch_floats`), counted once.  CUDA
    cores, four launches: the chunk states and the gradient's input terms,
    one block per (batch, chunk, head); both state passes, one thread per
    state element of a (batch, head); a block per (batch, chunk, head) for
    dx, ddt, the gradient of the chunk's cumsum and the head's shares of dB
    and dC; those shares summed over heads and da over (batch, chunk).
    Tensor cores, eight launches (``csrc/ssd_scan.cu`` namespace
    ``bwd_tc``): the forward's chunk states; the gradient's input terms;
    both state passes; row blocks (dB and dC's state terms summed over 8
    heads, dx's state term); column blocks (dS, S, dCB over 8 heads, dx);
    ddt; the dCB tiles and dB / dC summed in a fixed order.  The chunking is ``BWD_CHUNK``'s for the
    build whatever ``chunk`` is (the same function, summed in another
    order).  x, B and C are read in place through their batch and time
    strides; a ragged tail is masked."""
    _check(x.ndim == 4, f"x {tuple(x.shape)} must be (B, T, H, P)")
    B, T, H, P = x.shape
    _check(T > 0 and chunk > 0, f"T {T} and chunk {chunk} must be positive")
    _check(dt.shape == (B, T, H) and a.shape == (H,), f"dt {tuple(dt.shape)}, a {tuple(a.shape)}")
    _check(bm.ndim == 3 and bm.shape[:2] == (B, T) and cm.shape == bm.shape,
           f"bm {tuple(bm.shape)} and cm {tuple(cm.shape)} must be (B, T, N)")
    _check(dy.shape == x.shape, f"dy {tuple(dy.shape)} must be x's {tuple(x.shape)}")
    N = bm.shape[-1]
    for name, t in (("dh_final", dh_final), ("h0", h0)):
        _check(t is None or t.shape == (B, H, N, P), f"{name} shape {None if t is None else tuple(t.shape)}")
    dev = x.device
    _check(all(t.device == dev for t in (dt, a, bm, cm, dy) + tuple(t for t in (dh_final, h0) if t is not None)),
           "tensors on different devices")
    if dev.type == "cpu":
        return ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dh_final, h0)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(x.dtype == bm.dtype == cm.dtype, f"x, bm, cm dtypes {x.dtype}, {bm.dtype}, {cm.dtype} differ")
    _check(P % 4 == 0 and P <= PMAX and N % 4 == 0 and N <= NMAX,
           f"head dim {P} and state {N} must be multiples of 4 up to {PMAX} and {NMAX}")
    out = _launch_bwd(x, dt, a, bm, cm, dy, dh_final, h0)
    ssd_scan_bwd.launches += 1
    return out


def _aligned16(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` in f32, contiguous and 16-byte aligned (the state passes read
    and write four floats at a time; TMA reads dy), copied only where it is
    not."""
    if t is None:
        return None
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_bwd(x, dt, a, bm, cm, dy, dh_final, h0):
    """11_bwd's C entry on the wrapper's checked tensors, the build as
    :func:`ssd_scan_bwd_path` names it: outputs and scratch allocated here,
    x, B and C passed through their strides (on CUDA cores a copy only
    where the inner strides are not unit, as the forward's CUDA-core
    build); a refused launch raises."""
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    B, T, H, P = x.shape
    N = bm.shape[-1]
    dev = x.device
    f32 = torch.float32
    path = ssd_scan_bwd_path(x.dtype, N, P, tma_ready(x, bm, cm))
    x = _inner_contiguous(x, (P, 1))
    bm, cm = _inner_contiguous(bm, (1,)), _inner_contiguous(cm, (1,))
    dt, a = dt.to(f32).contiguous(), a.to(f32).contiguous()
    dy, dh_final, h0 = _aligned16(dy), _aligned16(dh_final), _aligned16(h0)
    dx = torch.empty((B, T, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, T, H), dtype=f32, device=dev)
    da = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((B, T, N), dtype=x.dtype, device=dev)
    dC = torch.empty((B, T, N), dtype=x.dtype, device=dev)
    dh0 = None if h0 is None else torch.empty((B, H, N, P), dtype=f32, device=dev)
    scratch = torch.empty((bwd_scratch_floats(B, T, H, N, P, path),), dtype=f32, device=dev)
    opt = lambda t: ptr(t) if t is not None else ctypes.c_void_p(None)
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    args = [ptr(x), x.stride(0), x.stride(1), ptr(dt), ptr(a), ptr(bm), bm.stride(0), bm.stride(1), ptr(cm),
            cm.stride(0), cm.stride(1), ptr(dy), opt(dh_final), opt(h0), ptr(dx), ptr(ddt), ptr(da), ptr(dB),
            ptr(dC), opt(dh0), ptr(scratch), B, T, H, N, P, stream_of(x)]
    argtypes = [vp, i64, i64, vp, vp, vp, i64, i64, vp, i64, i64, vp, vp, vp] + [vp] * 7 + [ctypes.c_int] * 5 + [vp]
    if path == "tensor_cores":
        rc = function("ssd_scan", "repro_ssd_scan_bwd_tc", argtypes)(*args)
    else:
        rc = function("ssd_scan", "repro_ssd_scan_bwd", [ctypes.c_int] + argtypes)(dtype_code(x.dtype), *args)
    check_launch(rc, "ssd_scan_bwd")
    return dx, ddt, da.to(a.dtype), dB, dC, dh0


ssd_scan_bwd.launches = 0


class _SsdScanTrain(torch.autograd.Function):
    """Kernel 11 with its gradient: the forward launches :func:`ssd_scan`
    and saves its inputs, the backward launches :func:`ssd_scan_bwd` (on the
    CPU both are the plain versions; on the card neither ever is).  x, B
    and C may be views of one projection: their gradients come back in
    their own shapes and types, and autograd routes them through the
    split."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, cm, h0, chunk):
        y, h = ssd_scan(x, dt, a, bm, cm, chunk, h0=h0)
        ctx.save_for_backward(x, dt, a, bm, cm, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused final state's gradient stays None: no zeros read
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, a, bm, cm, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, da, dB, dC, dh0 = ssd_scan_bwd(x, dt, a, bm, cm, ctx.chunk, dy, dh, h0)
        return (dx, ddt.to(dt.dtype), da.to(a.dtype), dB, dC, None if dh0 is None else dh0.to(h0.dtype), None)


def ssd_scan_train(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
    chunk: int = 128, h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable :func:`ssd_scan` (the training forward): (y, final
    state), with the gradients of x, dt, a, B, C and h0 from kernel 11's
    backward; a None gradient of the final state is zeros.  Under
    ``torch.no_grad`` it records nothing: the serving launch alone."""
    return _SsdScanTrain.apply(x, dt, a, bm, cm, h0, chunk)
