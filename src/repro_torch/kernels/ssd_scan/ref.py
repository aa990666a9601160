"""Plain PyTorch version of the chunked SSD scan kernel (``csrc/ssd_scan.cu``):
a port of the reference model's ``repro/models/mamba2.ssd_chunked``.

Per head h with state (N, P), over chunks of Q steps (inclusive cumsum
``cum`` of ``dt * a`` within each chunk, ``a < 0``):

    scores = (C B^T) o causal(exp(cum_i - cum_j)) o dt_j          (Q x Q)
    y      = scores @ x + (C o exp(cum)) @ h                       (Q x P)
    h      = exp(cum_last) h + (B o exp(cum_last - cum) dt)^T @ x  (N x P)

A ragged tail is padded with ``dt = 0`` rows, which add nothing to the
state.  The causal mask is applied before the exponential (the reference
selects after it): above the diagonal ``cum_i - cum_j`` is positive and
``exp`` of it may be ``inf``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_chunked(
    x: torch.Tensor,    # (B, T, H, P)
    dt: torch.Tensor,   # (B, T, H) post-softplus
    a: torch.Tensor,    # (H,) negative
    bm: torch.Tensor,   # (B, T, N)
    cm: torch.Tensor,   # (B, T, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, P), final state (B, H, N, P)), both f32."""
    Bsz, T, H, P = x.shape
    N = bm.shape[-1]
    Q = min(chunk, T)
    nc = -(-T // Q)
    pad = nc * Q - T
    f32 = torch.float32
    xc = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P)
    dtc = F.pad(dt.to(f32), (0, 0, 0, pad)).reshape(Bsz, nc, Q, H)
    bc = F.pad(bm.to(f32), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    cc = F.pad(cm.to(f32), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(dtc * a.to(f32), dim=2)  # inclusive, <= 0
    h = torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    above = ~torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq, cumq = xc[:, c], dtc[:, c], bc[:, c], cc[:, c], cum[:, c]
        cb = torch.einsum("bin,bjn->bij", cq, bq)
        diff = (cumq[:, :, None, :] - cumq[:, None, :, :]).masked_fill(above, float("-inf"))
        scores = cb[..., None] * torch.exp(diff) * dtq[:, None, :, :]  # (B, Qi, Qj, H)
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, xq)
        y_inter = torch.einsum("bin,bhnp->bihp", cq, h) * torch.exp(cumq)[..., None]
        last = cumq[:, -1:, :]
        w = torch.exp(last - cumq) * dtq  # (B, Q, H)
        s_chunk = torch.einsum("bjn,bjhp->bhnp", bq, w[..., None] * xq)
        h = torch.exp(last[:, 0])[:, :, None, None] * h + s_chunk
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, nc * Q, H, P)[:, :T]
    return y, h
