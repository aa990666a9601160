"""Plain PyTorch versions of the grouped GEMM kernel (``csrc/grouped_gemm.cu``)
and the grouped SwiGLU built on it: products in f32, one rounding to x's
type (the reference's ``preferred_element_type=f32`` then the cast)."""
from __future__ import annotations

import torch


def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> (E, M, N) in x's type."""
    return torch.bmm(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)


def grouped_swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = grouped_gemm(x, w_gate.to(x.dtype))
    u = grouped_gemm(x, w_up.to(x.dtype))
    return grouped_gemm(torch.nn.functional.silu(g) * u, w_down.to(x.dtype))
