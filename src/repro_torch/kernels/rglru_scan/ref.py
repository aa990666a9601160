"""Plain PyTorch version of the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

``h_t = a_t * h_{t-1} + b_t`` along axis 1, in f32: a loop over T.  The
reference's oracle (``repro/models/rglru.linear_scan``) is an associative
scan; the two agree to f32 rounding.
"""
from __future__ import annotations

from typing import Optional

import torch


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b: (B, T, W); h0: (B, W) or None (zeros).  Returns all h_t (B, T, W) f32."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    B, T, W = a32.shape
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device) if h0 is None else h0.to(torch.float32)
    out = torch.empty((B, T, W), dtype=torch.float32, device=a.device)
    for t in range(T):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out


rglru_scan = linear_scan
