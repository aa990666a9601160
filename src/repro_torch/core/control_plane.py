"""Control-plane plan computation (port of ``repro/core/control_plane.py``).

``route_topk``/``make_dispatch_plan`` (prefill) and ``route_topk_decode``
(decode) are the control plane: tiny tensors computed in f32.
``dispatch``/``combine`` are the plain data-plane consumers of a plan.

Two places where PyTorch differs from JAX and the port pins JAX's meaning:

* ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
  promises no order on ties.  :func:`_top_k` takes the first k of a stable
  descending sort instead (a zero router is all ties).
* ``.at[idx].set`` with duplicate targets: the only duplicate target is the
  dump slot ``E*C``, which is sliced off, so which write lands there does not
  matter — the same holds for PyTorch's index assignment.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.plans import DecodePlan, DispatchPlan


class RouterAux(NamedTuple):
    load_balance_loss: torch.Tensor  # scalar
    router_z_loss: torch.Tensor  # scalar
    fraction_dropped: torch.Tensor  # scalar, fraction of assignments over capacity


def capacity_for(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float, *, align: int = 8) -> int:
    """Static per-expert capacity C = ceil(cf * T * k / E), aligned up."""
    raw = math.ceil(capacity_factor * num_tokens * top_k / num_experts)
    return max(align, -(-raw // align) * align)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_probs(x: torch.Tensor, w_router: torch.Tensor):
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    return logits, torch.softmax(logits, dim=-1)


def route_topk(
    x: torch.Tensor,
    w_router: torch.Tensor,
    top_k: int,
    capacity: int,
    *,
    renormalize: bool = True,
) -> Tuple[DispatchPlan, RouterAux]:
    """Dispatch plan for tokens ``x`` (T, d) with router (d, E), in f32."""
    logits, probs = _router_probs(x, w_router)
    E = logits.shape[-1]
    top_w, top_e = _top_k(probs, top_k)
    if renormalize:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    plan = make_dispatch_plan(top_e, top_w, E, capacity)
    aux = RouterAux(
        load_balance_loss=load_balance_loss(probs, top_e),
        router_z_loss=torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        fraction_dropped=(plan.combine_idx < 0).to(torch.float32).mean(),
    )
    return plan, aux


def make_dispatch_plan(
    expert_ids: torch.Tensor,  # (T, k)
    weights: torch.Tensor,  # (T, k) f32
    num_experts: int,
    capacity: int,
) -> DispatchPlan:
    """Static-shape plan from router decisions: token-order capacity
    priority (earlier tokens win slots) through a stable sort by expert."""
    T, k = expert_ids.shape
    E, C = num_experts, capacity
    dev = expert_ids.device
    flat_e = expert_ids.reshape(-1).to(torch.int64)
    n = T * k
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    tok = ar // k

    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(ar)
    pos[sort_idx] = ar - starts[sorted_e]

    valid = pos < C
    slot = flat_e * C + pos
    scatter_to = torch.where(valid, slot, torch.full_like(slot, E * C))
    disp = torch.full((E * C + 1,), T, dtype=torch.int32, device=dev)
    disp[scatter_to] = tok.to(torch.int32)
    disp_valid = torch.zeros((E * C + 1,), dtype=torch.bool, device=dev)
    disp_valid[scatter_to] = valid

    flat_w = weights.reshape(-1).to(torch.float32)
    zero_w = torch.zeros_like(flat_w)
    combine_idx = torch.where(valid, slot, torch.full_like(slot, -1)).to(torch.int32).reshape(T, k)
    combine_w = torch.where(valid, flat_w, zero_w).reshape(T, k)
    slot_w = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev)
    slot_w[scatter_to] = torch.where(valid, flat_w, zero_w)
    disp = disp[:-1]
    return DispatchPlan(
        dispatch_idx=disp.reshape(E, C),
        dispatch_valid=disp_valid[:-1].reshape(E, C),
        combine_idx=combine_idx,
        combine_w=combine_w,
        flat_idx=disp,
        slot_w=slot_w[:-1],
        flat_cidx=scatter_to.to(torch.int32),
        flat_cw=combine_w.reshape(-1),
    )


def route_topk_decode(
    x: torch.Tensor,
    w_router: torch.Tensor,
    top_k: int,
    *,
    renormalize: bool = True,
) -> DecodePlan:
    """Decode-plane router: direct top-k assignment for tokens ``x`` (T, d)
    — no capacity, no sort over assignments, no scatter."""
    _, probs = _router_probs(x, w_router)
    top_w, top_e = _top_k(probs, top_k)
    if renormalize:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return DecodePlan(expert_ids=top_e.to(torch.int32), weights=top_w.to(torch.float32))


def topk_agreement(a_ids: torch.Tensor, b_ids: torch.Tensor) -> torch.Tensor:
    """Mean Jaccard overlap between two (T, k) top-k expert-id SETS (only the
    first occurrence of a duplicated id counts)."""
    k = a_ids.shape[-1]
    earlier = torch.tril(torch.ones((k, k), dtype=torch.bool, device=a_ids.device), -1)

    def first_occurrence(ids):
        dup = ids[..., :, None] == ids[..., None, :]
        return ~(dup & earlier).any(-1)

    fa, fb = first_occurrence(a_ids), first_occurrence(b_ids)
    inter = ((a_ids[..., :, None] == b_ids[..., None, :]).any(-1) & fa).sum(-1)
    union = fa.sum(-1) + fb.sum(-1) - inter
    return torch.mean(inter / torch.clamp(union, min=1))


def dispatch(x: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """Data plane: gather tokens (T, d) into expert slots (E, C, d)."""
    T, d = x.shape
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    return x_pad[plan.flat_dispatch_idx().long()].reshape(plan.num_experts, plan.capacity, d)


def combine(y_slots: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """Data plane: weighted gather of expert outputs (E, C, d) back to (T, d)."""
    E, C, d = y_slots.shape
    T, k = plan.combine_idx.shape
    y_flat = torch.cat([y_slots.reshape(E * C, d), y_slots.new_zeros((1, d))], dim=0)
    cidx, _ = plan.flat_combine_words()
    gathered = y_flat[cidx.long()].reshape(T, k, d)
    w = plan.combine_w.to(y_slots.dtype)[..., None]
    return (gathered * w).sum(dim=1)


def load_balance_loss(probs: torch.Tensor, top_e: torch.Tensor) -> torch.Tensor:
    """Switch-transformer auxiliary loss: E * sum_e f_e * P_e."""
    T, E = probs.shape
    k = top_e.shape[-1]
    sel = torch.bincount(top_e.reshape(-1), minlength=E).to(torch.float32) / (T * k)
    return E * torch.sum(sel * probs.mean(dim=0))
