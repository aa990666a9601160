"""Expert-parallel MoE over a mesh's ``model`` axis (port of
``repro/parallel/moe_parallel.py``): the data plane driven by the control
plane's dispatch plans, with the experts split across ranks.

Each rank holds its slice ``[r*E/ep, (r+1)*E/ep)`` of every expert stack
(:func:`repro_torch.parallel.sharding.shard_params`) and the replicated rest.
The reference runs these bodies under ``shard_map``; here every rank runs
them on its own tensors and the collectives are ``torch.distributed`` calls
on the mesh's process groups.  Every rank issues the same collectives in the
same order.

Two prefill strategies (chosen by sequence length, as the reference does):

* ``a2a``: the sequence splits over the ``model`` axis; each rank routes its
  chunk, dispatches it into fixed-capacity slots (E, C, d) (kernel 9), one
  ``all_to_all_single`` re-buckets the slots so each rank holds
  (E/ep, ep*C, d) for its local experts, the local experts run
  (:func:`repro_torch.kernels.moe_fused.fused_experts_fn`: kernel 3 over the
  identity index, then kernel 8), the reverse ``all_to_all_single`` brings
  the outputs home, the combine (kernel 10) weights them back into tokens,
  and an all-gather over the sequence restores (B, S, d).
* ``psum``: every rank routes the same tokens and runs the fused pair
  (kernels 3 and 4) over its contiguous slot range of the flat plan words;
  one ``all_reduce`` sums the partial outputs.

The decode plane (:func:`make_sharded_decode_apply`) filters the
cache-carried ``DecodePlan`` against the rank's experts
(``DecodePlan.shard_slice``), runs kernel 2 over the local stacks and sums
the partial outputs with one ``all_reduce``.

The port always takes the reference's fused branch (its ``use_pallas=True``
data plane).  On CPU tensors every kernel takes its plain version.

Both bodies train: every kernel is called through its autograd Function
(kernel 9's backward is kernel 10 with unit weights, kernel 10's is 10_bwd,
kernels 3 and 8 over the identity index have 3_bwd and 8_bwd, the ``psum``
body's pair 3 and 4 has 3_bwd and 4_bwd) and every collective through
:mod:`repro_torch.parallel.collectives`' differentiable ones, whose
backward is right for each tensor's replication across the ``model`` ranks
(every rank holds the layer's input and output whole; the loss is on every
rank): the ``a2a`` body's sequence split gathers the chunks' gradients, its
final all-gather keeps the rank's own slice of the (whole) gradient, the
router and the shared experts, used by each rank on its own chunk, have
their gradients summed over ``model``, the all_to_alls exchange the
gradient's blocks back, and the aux losses' mean over ranks passes 1 / ep
of its gradient to each rank's share (their mean over the data axes comes
with the train step's gradient mean).  In the ``psum`` body every rank
routes the whole sequence, so the router's gradient is whole on each; its
slot-weight range is split (its gradient gathered) and the input's
gradient, a part from each rank's experts, is summed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.control_plane import capacity_for, route_topk
from repro_torch.core.plans import DecodePlan
from repro_torch.kernels.moe_decode import decode_moe
from repro_torch.kernels.moe_dispatch import combine_fn, dispatch_fn
from repro_torch.kernels.moe_fused.ops import fused_experts_fn, fused_moe_train
from repro_torch.models.moe import _shared_experts
from repro_torch.parallel.collectives import all_to_all, gather, pmean, psum, split, sum_grad

Params = Dict[str, Any]

EP_AXIS = "model"  # the mesh axis the experts split over
_STACKS = ("w_gate", "w_up", "w_down", "w_gate_q", "w_up_q", "w_down_q")


def _moe_param_specs(p_example: Params) -> Params:
    """Spec tree of an MoE param dict: expert stacks over ``model``, the
    (E,) scale words on the same axis, the rest replicated."""
    specs: Params = {}
    for k in p_example:
        if k in _STACKS:
            specs[k] = ("model", None, None)
        elif k in ("w_gate_s", "w_up_s", "w_down_s"):
            specs[k] = ("model",)
        elif k == "shared":
            specs[k] = {kk: () for kk in p_example[k]}
        else:
            specs[k] = ()
    return specs


def _check_local(p: Params, e_loc: int, ep: int) -> None:
    n = p["w_gate"].shape[0]
    if n != e_loc:
        raise ValueError(f"the expert stacks hold {n} experts but a rank of a {ep}-way 'model' axis holds "
                         f"{e_loc}: place the weights with repro_torch.parallel.sharding.shard_params")


def make_sharded_moe_apply(cfg: ModelConfig, mesh, batch_axes: Tuple[str, ...]):
    """The distributed MoE apply ``(x_ffn, route_src, p) -> (y, aux (2,))``
    over the mesh's ``model`` axis, differentiable (module docstring).

    ``x_ffn`` is this rank's (B, S, d) share of the batch (``batch_axes``
    name the mesh axes the batch is split over; the aux losses are averaged
    over them and the ``model`` axis)."""
    E, k = cfg.num_experts, cfg.top_k
    ep = mesh.shape[EP_AXIS]
    if E % ep:
        raise ValueError(f"{E} experts not divisible by ep={ep}")
    E_loc = E // ep
    cf = cfg.capacity_factor
    midx = mesh.coords[EP_AXIS]
    g_ep = mesh.group(EP_AXIS)
    all_axes = tuple(batch_axes) + (EP_AXIS,)
    g_all, n_all = mesh.group(all_axes), 1
    for a in all_axes:
        n_all *= mesh.shape[a]
    g_batch = mesh.group(batch_axes) if batch_axes else None
    n_batch = n_all // ep

    def _a2a_body(x, rs, p):
        B, S, d = x.shape
        Sc = S // ep
        xs = split(x, g_ep, 1).reshape(B * Sc, d)  # this rank's sequence chunk
        rss = split(rs, g_ep, 1).reshape(B * Sc, d)
        T_loc = B * Sc
        C = capacity_for(T_loc, E, k, cf)
        # control plane: this rank's chunk's plan (tiny tensors)
        plan, aux = route_topk(rss, sum_grad(p["router"], g_ep), k, C)
        # data plane: dispatch -> a2a -> experts -> a2a -> combine
        slots = dispatch_fn(xs, plan)  # (E, C, d), expert-major, experts of rank j in block j
        recv = all_to_all(slots, g_ep)  # (ep sources, E_loc, C, d)
        local = recv.view(ep, E_loc, C, d).transpose(0, 1).reshape(E_loc, ep * C, d)  # slot src*C + c
        y_loc = fused_experts_fn(local, p)  # (E_loc, ep*C, d)
        send = y_loc.view(E_loc, ep, C, d).transpose(0, 1).contiguous()  # block j: rank j's tokens
        back = all_to_all(send, g_ep)  # (ep owners, E_loc, C, d) = (E, C, d)
        y = combine_fn(back.view(E, C, d), plan).to(x.dtype)  # (T_loc, d)
        if "shared" in p:  # shared experts: replicated weights, local tokens
            y = y + _shared_experts(xs, {"shared": {n: sum_grad(w, g_ep) for n, w in p["shared"].items()}})
        y = gather(y.reshape(B, Sc, d), g_ep, 1)  # (B, S, d)
        aux_v = pmean(torch.stack([aux.load_balance_loss, aux.router_z_loss]), g_all, n_all, 1.0 / ep)
        return y, aux_v

    def _psum_body(x, rs, p):
        B, S, d = x.shape
        T = B * S
        C = capacity_for(T, E, k, cf)
        xf = x.reshape(T, d)
        plan, aux = route_topk(rs.reshape(T, d), p["router"], k, C)
        # experts [midx*E_loc, (midx+1)*E_loc) are one contiguous range of the
        # flat slot words: no (E, C, d) tensor is formed
        base = midx * E_loc * C
        loc_idx = plan.flat_dispatch_idx()[base:base + E_loc * C]
        # the range's slot weights (their gradient gathered over model), the
        # input (its gradient a part from each rank's experts) and the
        # assignments' local slots (E_loc*C: another rank's or dropped)
        cidx, _ = plan.flat_combine_words()
        loc = cidx - base
        loc_cidx = torch.where((loc >= 0) & (loc < E_loc * C), loc, torch.full_like(loc, E_loc * C))
        y = fused_moe_train(sum_grad(xf, g_ep), loc_idx, split(plan.flat_slot_w(), g_ep, 0), p, loc_cidx)
        # each rank's part in x's type before the sum, as the reference's
        # psum body sums them (its fused_moe_apply, and its plain combine,
        # return x's type)
        y = psum(y.to(x.dtype), g_ep)
        if "shared" in p:
            y = y + _shared_experts(xf, p)
        aux_v = torch.stack([aux.load_balance_loss, aux.router_z_loss])
        if g_batch is not None:
            aux_v = pmean(aux_v, g_batch, n_batch)
        return y.reshape(B, S, d), aux_v

    def moe_apply(x_ffn: torch.Tensor, route_src: Optional[torch.Tensor], p: Params):
        _check_local(p, E_loc, ep)
        rs = x_ffn if (route_src is None or cfg.route_mode != "lookahead") else route_src
        S = x_ffn.shape[1]
        body = _a2a_body if S % ep == 0 and S >= ep else _psum_body
        return body(x_ffn, rs, p)

    return moe_apply


def make_sharded_decode_apply(cfg: ModelConfig, mesh, batch_axes: Tuple[str, ...]):
    """The distributed Agile decode plane ``(x_ffn (B, S, d), plan, p) -> y``:
    the cache-carried plan arrives replicated, each rank keeps the
    assignments to its resident experts (``DecodePlan.shard_slice``: a mask
    on expert ids), runs the capacity-free decode data plane over its local
    stacks only, and one ``all_reduce`` sums the partial outputs; the shared
    experts are added after it.  On a one-rank ``model`` axis the slice and
    the sum are skipped: both are identities there, and they cost eager
    launches on every MoE layer of every decode launch.  The router does not
    run here."""
    E, k = cfg.num_experts, cfg.top_k
    ep = mesh.shape[EP_AXIS]
    if E % ep:
        raise ValueError(
            f"distributed decode plane: {E} experts are not divisible by the "
            f"'{EP_AXIS}' mesh axis ({ep}); pick a model-parallel degree that "
            f"divides num_experts (or 1)"
        )
    E_loc = E // ep
    first = mesh.coords[EP_AXIS] * E_loc
    g_ep = mesh.group(EP_AXIS)

    def decode_apply(x_ffn: torch.Tensor, plan: DecodePlan, p: Params) -> torch.Tensor:
        _check_local(p, E_loc, ep)
        B, S, d = x_ffn.shape
        xf = x_ffn.reshape(B * S, d)
        flat = DecodePlan(plan.expert_ids.reshape(B * S, k), plan.weights.reshape(B * S, k))
        if ep == 1:  # every expert resident: the slice and the sum are identities
            y = decode_moe(xf, flat, p)
        else:
            y = decode_moe(xf, flat.shard_slice(first, E_loc), p)
            dist.all_reduce(y, group=g_ep)
        y = y.to(x_ffn.dtype)
        if "shared" in p:  # replicated weights, added after the sum
            y = y + _shared_experts(xf, p)
        return y.reshape(B, S, d)

    return decode_apply
