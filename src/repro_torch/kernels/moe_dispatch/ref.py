"""Plain PyTorch versions of the dispatch and combine kernels
(``csrc/moe_dispatch.cu``): they delegate to the control plane's data-plane
consumers (:mod:`repro_torch.core.control_plane`), the semantics' source of
truth, as the reference's ``moe_dispatch/ref.py`` does.

``combine`` sums in f32 and rounds once to ``y_slots``' type, as the
reference's ``combine_pallas`` (f32 output) followed by ``ops.combine`` (the
cast) does; on f32 slots it is ``control_plane.combine`` itself.
"""
from __future__ import annotations

import torch

from repro_torch.core.control_plane import combine as _combine
from repro_torch.core.control_plane import dispatch as _dispatch
from repro_torch.core.plans import DispatchPlan


def dispatch(x: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    return _dispatch(x, plan)


def dispatch_words(x: torch.Tensor, idx: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """:func:`dispatch` on the flat slot index ``idx`` (E*C,), T naming the
    zero row (the gather of ``control_plane.dispatch``)."""
    T, d = x.shape
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    return x_pad[idx.long()].reshape(E, C, d)


def combine(y_slots: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    return _combine(y_slots.to(torch.float32), plan).to(y_slots.dtype)


def combine_words(y_flat: torch.Tensor, cidx: torch.Tensor, w: torch.Tensor, T: int) -> torch.Tensor:
    """:func:`combine` on the flat words: y (T, d) with ``y[t] = sum_j w[t*k
    + j] * y_flat[cidx[t*k + j]]``, index ``len(y_flat)`` (a dropped
    assignment) adding nothing; summed in f32 over j, rounded once to
    ``y_flat``'s type (the arithmetic of ``control_plane.combine``)."""
    n, d = y_flat.shape
    k = cidx.numel() // T
    pad = torch.cat([y_flat.to(torch.float32), y_flat.new_zeros((1, d), dtype=torch.float32)], dim=0)
    gathered = pad[cidx.long()].reshape(T, k, d)
    return (gathered * w.to(torch.float32).reshape(T, k, 1)).sum(dim=1).to(y_flat.dtype)


def dispatch_bwd(dslots: torch.Tensor, cidx: torch.Tensor, T: int) -> torch.Tensor:
    """dispatch's backward: dx (T, d) = the sum of each token's slot rows of
    ``dslots`` (E*C, d) in ascending j (:func:`combine_words` with unit
    weights; a dropped assignment adds nothing)."""
    return combine_words(dslots, cidx, torch.ones(cidx.shape, dtype=torch.float32, device=cidx.device), T)


def combine_bwd(dy: torch.Tensor, y_flat: torch.Tensor, cidx: torch.Tensor, w: torch.Tensor,
                flat_idx: torch.Tensor):
    """combine's backward (10_bwd) for the gradient dy (T, d): ``dslots``
    (E*C, d) in y's type, ``dslots[cidx[t, j]] = w[t, j] dy[t]`` (one f32
    product, rounded once) and zero rows where no kept assignment points;
    ``dw`` (T*k,) f32, ``<dy[t], y_flat[cidx[t, j]]>`` summed in f32 (0 for a
    dropped assignment).  ``flat_idx`` is read by the kernel alone (its
    empty slots); here a slot no kept word names stays zero."""
    T, d = dy.shape
    n = y_flat.shape[0]
    k = cidx.numel() // T
    c = cidx.long()
    kept = (c >= 0) & (c < n)
    tok = torch.arange(T, device=dy.device).repeat_interleave(k)
    dyf = dy.to(torch.float32)
    rows = torch.zeros((n + 1, d), dtype=torch.float32, device=dy.device)
    dst = torch.where(kept, c, torch.full_like(c, n))
    rows[dst[kept]] = w.to(torch.float32)[kept, None] * dyf[tok[kept]]
    pad = torch.cat([y_flat.to(torch.float32), y_flat.new_zeros((1, d), dtype=torch.float32)], dim=0)
    dw = torch.where(kept, (dyf[tok] * pad[dst]).sum(dim=-1), torch.zeros((), dtype=torch.float32, device=dy.device))
    return rows[:n].to(y_flat.dtype), dw
