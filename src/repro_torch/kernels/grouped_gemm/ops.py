"""Grouped GEMM wrappers (port of ``repro/kernels/grouped_gemm/ops.py``).

:func:`grouped_gemm` is the launch: its plain version (``ref.py``) on CPU
tensors, ``csrc/grouped_gemm.cu`` on ``cuda`` tensors (counted in
``launches``), or an error.  On the card it takes one of two builds, named
by :func:`grouped_gemm_path`: bf16 with 16-byte strides and bases on tensor
cores (wgmma fed by TMA, which zero-fills the ragged edges), everything
else on CUDA cores (ragged M, K and N masked inside the kernel); neither
makes padded copies.  :func:`grouped_swiglu` and :func:`experts_fn` (the
reference's ``pallas_experts_fn``) build the per-expert SwiGLU on it.
:func:`grouped_gemm_bwd` is its backward (8_bwd: dx and dw in one call,
the build :func:`grouped_gemm_bwd_path` names, the tensor-core build on the
schedule :func:`grouped_gemm_bwd_schedule` names), which
``moe_fused.ops.fused_experts_fn`` runs under autograd.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.grouped_gemm import ref


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"grouped_gemm: {msg}")


def grouped_gemm_path(dtype: torch.dtype, K: int, N: int, aligned: bool) -> str:
    """Which build of kernel 8 a launch takes, from its dtype, K, N and
    whether x, w and y start on 16-byte boundaries: ``"tensor_cores"``
    (bf16 wgmma tiles fed by TMA, which needs every global stride and base
    a multiple of 16 bytes: K and N multiples of 8) or ``"cuda_cores"``
    (f32 products; f32, and bf16 at any other shape)."""
    ok = dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0 and aligned
    return "tensor_cores" if ok else "cuda_cores"


def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ w[e]: (E, M, K) @ (E, K, N) -> (E, M, N), accumulated
    in f32, in x's type.  On the card the launch takes the build
    :func:`grouped_gemm_path` names."""
    _check(x.ndim == 3 and w.ndim == 3 and x.shape[0] == w.shape[0] and x.shape[2] == w.shape[1],
           f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    _check(x.dtype == w.dtype, f"x is {x.dtype} but w is {w.dtype}")
    if x.device.type == "cpu":
        _check(w.device.type == "cpu", "tensors on different devices")
        return ref.grouped_gemm(x, w)
    _check(x.device == w.device, "tensors on different devices")
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    x, w = x.contiguous(), w.contiguous()
    from repro_torch.kernels import check_launch, dtype_code, function, stream_of

    E, M, K = x.shape
    N = w.shape[2]
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    if grouped_gemm_path(x.dtype, K, N, aligned) == "tensor_cores":
        fn = function("grouped_gemm", "repro_grouped_gemm_tc", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
        rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), E, M, K, N, stream_of(x))
    else:
        vec = int((N * w.element_size()) % 16 == 0 and w.data_ptr() % 16 == 0)
        fn = function("grouped_gemm", "repro_grouped_gemm", [ctypes.c_int] + [ctypes.c_void_p] * 3
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        rc = fn(dtype_code(x.dtype), x.data_ptr(), w.data_ptr(), y.data_ptr(), E, M, K, N, vec, stream_of(x))
    check_launch(rc, "grouped_gemm")
    grouped_gemm.launches += 1
    return y


grouped_gemm.launches = 0


def grouped_gemm_bwd_path(dtype: torch.dtype, K: int, N: int, aligned: bool) -> str:
    """Which build of kernel 8's backward a launch takes, from its dtype, K,
    N and whether x, w, dy and the outputs start on 16-byte boundaries:
    ``"tensor_cores"`` (bf16 wgmma tiles fed by TMA, every row stride a
    multiple of 16 bytes: K and N multiples of 8) or ``"cuda_cores"`` (f32
    products; f32, and bf16 at any other shape)."""
    ok = dtype == torch.bfloat16 and K > 0 and N > 0 and K % 8 == 0 and N % 8 == 0 and aligned
    return "tensor_cores" if ok else "cuda_cores"


# dw keeps a unit's dy slice (rows of M x 256 columns, in 64-row chunks) in
# shared memory while at most this many chunks fit beside x's ring
# (``csrc/grouped_gemm.cu``'s DW_RESIDENT_CHUNKS; its entry refuses more)
BWD_RESIDENT_CHUNKS = 5


def grouped_gemm_bwd_schedule(M: int) -> str:
    """dw's schedule on the tensor-core build of kernel 8's backward at M
    rows, which the launch passes to its C entry: ``"dy_resident"`` while
    a unit's dy slice, ceil(M / 64) chunks of 64 rows x 256 columns (32 KB
    each), fits in shared memory (at most 5: M <= 320, Qwen3-MoE's a2a
    training shape), else ``"dy_streamed"`` (each stage brings dy's chunk
    beside x's tile).  dx has one schedule at every shape."""
    _check(M > 0, f"no rows (M {M})")
    return "dy_resident" if -(-M // 64) <= BWD_RESIDENT_CHUNKS else "dy_streamed"


def grouped_gemm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """Kernel 8's backward (8_bwd) for the gradient dy (E, M, N) of
    ``grouped_gemm(x, w)``: ``(dx, dw)`` = (dy[e] @ w[e]^T, x[e]^T @ dy[e]),
    f32 sums in a fixed order, in x's type.  On the card the build
    :func:`grouped_gemm_bwd_path` names, counted once: two launches on CUDA
    cores, three on tensor cores (a touch that makes the context current
    on autograd's thread, then dx, then dw, on the schedule
    :func:`grouped_gemm_bwd_schedule` names)."""
    _check(x.ndim == 3 and w.ndim == 3 and dy.ndim == 3, "x, w and dy must be 3-D")
    E, M, K = x.shape
    N = w.shape[2]
    _check(w.shape == (E, K, N) and dy.shape == (E, M, N), f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
           f"dy {tuple(dy.shape)}")
    _check(x.dtype == w.dtype == dy.dtype, f"x, w and dy must share a dtype ({x.dtype}, {w.dtype}, {dy.dtype})")
    if x.device.type == "cpu":
        _check(w.device.type == "cpu" and dy.device.type == "cpu", "tensors on different devices")
        return ref.grouped_gemm_bwd(x, w, dy)
    _check(x.device == w.device == dy.device, "tensors on different devices")
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    return _launch_bwd(x.contiguous(), w.contiguous(), dy.contiguous())


def _launch_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """:func:`grouped_gemm_bwd`'s launch on contiguous tensors of one card."""
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    E, M, K = x.shape
    N = w.shape[2]
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, dy, dx, dw))
    if grouped_gemm_bwd_path(x.dtype, K, N, aligned) == "tensor_cores":
        resident = int(grouped_gemm_bwd_schedule(M) == "dy_resident")
        rc = function("grouped_gemm", "repro_grouped_gemm_bwd_tc", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])(ptr(x), ptr(w), ptr(dy), ptr(dx), ptr(dw), E, M, K, N, resident,
                                           stream_of(x))
    else:
        rc = function("grouped_gemm", "repro_grouped_gemm_bwd", [ctypes.c_int] + [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])(
            dtype_code(x.dtype), ptr(x), ptr(w), ptr(dy), ptr(dx), ptr(dw), E, M, K, N, stream_of(x))
    check_launch(rc, "grouped_gemm_bwd")
    grouped_gemm_bwd.launches += 1
    return dx, dw


grouped_gemm_bwd.launches = 0


def grouped_swiglu(
    x_slots: torch.Tensor,  # (E, C, d)
    w_gate: torch.Tensor,   # (E, d, f)
    w_up: torch.Tensor,
    w_down: torch.Tensor,   # (E, f, d)
) -> torch.Tensor:
    """Per-expert SwiGLU of the slots, three grouped GEMMs, in x's type."""
    dt = x_slots.dtype
    g = grouped_gemm(x_slots, w_gate.to(dt))
    u = grouped_gemm(x_slots, w_up.to(dt))
    return grouped_gemm(torch.nn.functional.silu(g) * u, w_down.to(dt))


def experts_fn(x_slots: torch.Tensor, p) -> torch.Tensor:
    """The ``experts_fn`` signature of the MoE data plane: (E, C, d) slots
    through the layer's expert stacks ``p``."""
    return grouped_swiglu(x_slots, p["w_gate"], p["w_up"], p["w_down"])
