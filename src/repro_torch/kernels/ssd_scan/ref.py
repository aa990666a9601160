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

:func:`ssd_chunked_bwd` is the plain version of its backward
(``repro_ssd_scan_bwd``), written out chunk by chunk in closed form.
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


def ssd_chunked_bwd(
    x: torch.Tensor,    # (B, T, H, P)
    dt: torch.Tensor,   # (B, T, H) post-softplus
    a: torch.Tensor,    # (H,) negative
    bm: torch.Tensor,   # (B, T, N)
    cm: torch.Tensor,   # (B, T, N)
    chunk: int,
    dy: torch.Tensor,   # (B, T, H, P): dL/dy
    dh_final: Optional[torch.Tensor] = None,  # (B, H, N, P): dL/d(final state); None = zeros
    h0: Optional[torch.Tensor] = None,        # (B, H, N, P)
):
    """``(dx, ddt, da, dB, dC, dh0)`` of :func:`ssd_chunked`, each in its
    input's type (dh0 f32; None without ``h0``).  The states entering the
    chunks are recomputed in order; then, for chunks in descending order,
    with ``g`` the gradient of the state a chunk leaves and ``hp`` the one
    it enters, ``E_ij = exp(cum_i - cum_j)`` (i >= j) and ``w_j =
    exp(cum_last - cum_j) dt_j``:

        dS_ij = dy_i . x_j                      dCB_ij = sum_h dS_ij E_ij dt_j
        dx_j  = sum_i S_ij dy_i + w_j (g^T B_j)
        dC_i  = sum_j dCB_ij B_j + exp(cum_i) hp dy_i      (summed over heads)
        dB_j  = sum_i dCB_ij C_i + w_j g x_j               (summed over heads)
        g    <- exp(cum_last) g + sum_i exp(cum_i) C_i dy_i^T

    and the gradient of ``cum`` (through E, w, exp(cum_i) and the chunk's
    decay) turns into ``ddt`` and ``da`` by a reverse cumsum within the
    chunk, since ``cum = cumsum(dt * a)``; ``dh0`` is the last ``g``."""
    Bsz, T, H, P = x.shape
    N = bm.shape[-1]
    Q = min(chunk, T)
    nc = -(-T // Q)
    pad = nc * Q - T
    f32 = torch.float32
    xc = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P)
    dyc = F.pad(dy.to(f32), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P)
    dtc = F.pad(dt.to(f32), (0, 0, 0, pad)).reshape(Bsz, nc, Q, H)
    bc = F.pad(bm.to(f32), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    cc = F.pad(cm.to(f32), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    a32 = a.to(f32)
    cum = torch.cumsum(dtc * a32, dim=2)
    last = cum[:, :, -1]  # (B, nc, H)
    h = torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    entering = []
    for c in range(nc):
        entering.append(h)
        w = torch.exp(last[:, c, None] - cum[:, c]) * dtc[:, c]
        h = torch.exp(last[:, c])[:, :, None, None] * h + torch.einsum("bjn,bjhp->bhnp", bc[:, c], w[..., None] * xc[:, c])
    g = torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device) if dh_final is None else dh_final.to(f32)
    above = ~torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    dxs, ddts, dbs, dcs = [None] * nc, [None] * nc, [None] * nc, [None] * nc
    da = torch.zeros((H,), dtype=f32, device=x.device)
    for c in range(nc - 1, -1, -1):
        xq, dyq, dtq, bq, cq, cumq, hp = xc[:, c], dyc[:, c], dtc[:, c], bc[:, c], cc[:, c], cum[:, c], entering[c]
        lastq = last[:, c]  # (B, H)
        cb = torch.einsum("bin,bjn->bij", cq, bq)
        E = torch.exp((cumq[:, :, None, :] - cumq[:, None, :, :]).masked_fill(above, float("-inf")))
        S = cb[..., None] * E * dtq[:, None, :, :]                   # (B, Qi, Qj, H)
        dS = torch.einsum("bihp,bjhp->bijh", dyq, xq)
        M = dS * cb[..., None] * E                                   # dL/dS o S / dt_j
        dcb = (dS * E * dtq[:, None, :, :]).sum(-1)                  # (B, Qi, Qj)
        ein = torch.exp(cumq)                                        # (B, Q, H)
        w = torch.exp(lastq[:, None] - cumq) * dtq                   # (B, Q, H)
        v = torch.einsum("bihp,bhnp->bihn", dyq, hp)                 # hp dy_i
        z = torch.einsum("bjhp,bhnp->bjhn", xq, g)                   # g x_j
        u = torch.einsum("bjn,bhnp->bjhp", bq, g)                    # g^T B_j
        dcs[c] = torch.einsum("bij,bjn->bin", dcb, bq) + torch.einsum("bih,bihn->bin", ein, v)
        dbs[c] = torch.einsum("bij,bin->bjn", dcb, cq) + torch.einsum("bjh,bjhn->bjn", w, z)
        dxs[c] = torch.einsum("bijh,bihp->bjhp", S, dyq) + w[..., None] * u
        dw = (xq * u).sum(-1)                                        # dL/dw_j
        cs = M.sum(1)                                                # (B, Qj, H)
        dcum = ((M * dtq[:, None, :, :]).sum(2) - dtq * cs
                + ein * torch.einsum("bin,bihn->bih", cq, v) - w * dw)
        dlast = (w * dw).sum(1) + torch.exp(lastq) * (g * hp).sum((-2, -1))
        dcum[:, -1] += dlast
        dl = torch.flip(torch.cumsum(torch.flip(dcum, [1]), dim=1), [1])  # reverse cumsum over the chunk
        ddts[c] = cs + torch.exp(lastq[:, None] - cumq) * dw + dl * a32
        da = da + (dl * dtq).sum((0, 1))
        g = (torch.exp(lastq)[:, :, None, None] * g
             + torch.einsum("bih,bin,bihp->bhnp", ein, cq, dyq))
    dx = torch.stack(dxs, 1).reshape(Bsz, nc * Q, H, P)[:, :T]
    ddt = torch.stack(ddts, 1).reshape(Bsz, nc * Q, H)[:, :T]
    dB = torch.stack(dbs, 1).reshape(Bsz, nc * Q, N)[:, :T]
    dC = torch.stack(dcs, 1).reshape(Bsz, nc * Q, N)[:, :T]
    return (dx.to(x.dtype), ddt.to(dt.dtype), da.to(a.dtype), dB.to(bm.dtype), dC.to(cm.dtype),
            None if h0 is None else g)
