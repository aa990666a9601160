"""Plain PyTorch version of the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

``h_t = a_t * h_{t-1} + b_t`` along axis 1, in f32: a loop over T.  The
reference's oracle (``repro/models/rglru.linear_scan``) is an associative
scan; the two agree to f32 rounding.  :func:`rglru_scan_bwd` is the plain
version of its backward (``repro_rglru_scan_bwd``), a loop over reversed T.
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


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """(da, db, dh0) of :func:`linear_scan` given its output h and g =
    dL/dh: delta_t = g_t + a_{t+1} delta_{t+1}, db = delta, da_t = delta_t
    h_{t-1} (h0, or 0, before the first step), in a's type; dh0 = a_0
    delta_0 in f32, None without h0."""
    a32, g32 = a.to(torch.float32), g.to(torch.float32)
    B, T, W = a32.shape
    delta = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    db = torch.empty((B, T, W), dtype=torch.float32, device=a.device)
    for t in range(T - 1, -1, -1):
        delta = (a32[:, t + 1] * delta if t + 1 < T else delta) + g32[:, t]
        db[:, t] = delta
    first = torch.zeros((B, 1, W), dtype=torch.float32, device=a.device) if h0 is None else h0.to(torch.float32)[:, None]
    da = db * torch.cat([first, h.to(torch.float32)[:, :-1]], dim=1)
    dh0 = None if h0 is None else a32[:, 0] * db[:, 0]
    return da.to(a.dtype), db.to(a.dtype), dh0
