"""Plain PyTorch versions of the grouped GEMM kernel (``csrc/grouped_gemm.cu``)
and the grouped SwiGLU built on it: products in f32, one rounding to x's
type (the reference's ``preferred_element_type=f32`` then the cast)."""
from __future__ import annotations

import torch


def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> (E, M, N) in x's type."""
    return torch.bmm(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


def grouped_gemm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """The backward of :func:`grouped_gemm` for the gradient dy (E, M, N):
    (dx = dy @ w^T, dw = x^T @ dy), products in f32, each rounded once to
    x's type."""
    f = torch.float32
    dyf = dy.to(f)
    dx = torch.bmm(dyf, w.to(f).transpose(1, 2)).to(x.dtype)
    dw = torch.bmm(x.to(f).transpose(1, 2), dyf).to(x.dtype)
    return dx, dw


def grouped_swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = grouped_gemm(x, w_gate.to(x.dtype))
    u = grouped_gemm(x, w_up.to(x.dtype))
    return grouped_gemm(torch.nn.functional.silu(g) * u, w_down.to(x.dtype))
