"""Analytic cost model of a step: the card's peaks, the HBM-traffic model, the
model FLOPs, the collectives the port's step issues, and the three-term
roofline (port of the analytic half of ``repro/launch/analysis.py``).

The reference reads a step's FLOPs, bytes and collectives from XLA's
compiled program (``extract_cost``, ``extract_memory``, and
``parse_collectives`` over the optimized HLO); the port has no compiled
program, so its counterparts are counts made from the config and the
shapes: :func:`step_flops` (the FLOPs of one step), the ranks' bytes in
:mod:`repro_torch.launch.dryrun`, and :func:`collective_bytes` (what the
port's own step issues per rank, in ``parse_collectives``' form).
:func:`analytic_memory_bytes`, :func:`model_flops` and :func:`roofline`
are the reference's, arithmetic and quirks included, with the card's peaks
in place of the TPU's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

# One H100 SXM at its full 700 W power limit: the dense peaks of NVIDIA's
# data sheet.  ICI_BW keeps the reference's name for the link a collective
# crosses: NVLink 4's rate each way per card.
PEAK_FLOPS = 989e12          # bf16 FLOP/s on the tensor cores
F32_FLOPS = 67e12            # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
ICI_BW = 450e9               # bytes/s each way per card (NVLink 4)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# the reference's control-plane rule: integer payloads, or tiny (<= 256 KiB) ones
CONTROL_BYTES_LIMIT = 256 * 1024

_ATTN_KINDS = ("attn", "local", "moe")
_METRICS = 4  # the train step's metrics vector: loss, ce, lb_loss, z_loss


def analytic_memory_bytes(cfg, cell, n_model: int, n_data: int) -> Dict[str, float]:
    """Per-device HBM traffic model (bytes / step), the reference's
    placement: weights f32, split over ``model`` and replicated over
    ``data``; train reads them 3 times, writes and reads the gradient and
    runs the optimizer (~10x param bytes under AdamW, ~6x Adafactor),
    prefill and decode read every active weight once; ~6 residual-sized
    and ~4 FFN-width activation tensors a layer (x4 for train), the FFN's
    split over ``model``; decode reads each sequence's whole KV cache (or
    recurrent state); MoE charges the top-k experts' width.

    This is the reference's placement, not the port's: the port's ``tp``
    gathers every dense leaf whole before its use
    (``launch/steps._MeshTrainStep._gather``; ROADMAP Queue A item 4), so
    it moves more than this model counts."""
    d = cfg.d_model
    pf = 4  # param bytes (f32 master)
    ab = 2 if cell.step != "train" or cfg.dtype == "bfloat16" else 2  # bf16 acts (the reference's: 2 either way)
    B, S = cell.global_batch, cell.seq_len
    B_loc = max(B // n_data, 1)
    T_loc = B_loc * (S if cell.step in ("train", "prefill") else 1)

    total_param_b = cfg.num_params() * pf
    active_param_b = cfg.num_active_params() * pf
    pb_local = total_param_b / n_model
    pb_active_local = active_param_b / n_model

    if cell.step == "train":
        opt_mult = 10.0 if cfg.optimizer == "adamw" else 6.0
        weight_traffic = opt_mult * pb_local
        act_mult = 4.0
    else:
        weight_traffic = pb_active_local
        act_mult = 1.0

    A_res = T_loc * d * ab
    traffic = 0.0
    for kind in cfg.layer_kinds:
        if kind in _ATTN_KINDS:
            dff = (cfg.d_ff_expert or cfg.d_ff) if kind == "moe" else cfg.d_ff
            width = dff * (cfg.top_k if kind == "moe" else 1)
            layer = 6 * A_res + 4 * T_loc * (width / n_model if kind != "moe" else width) * ab
            ctx = min(S, cfg.local_window or S)
            if cell.step == "decode":
                layer += B_loc * ctx * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * ab
            else:
                layer += T_loc * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * ab
        elif kind == "rec":
            layer = 6 * A_res + 6 * T_loc * (cfg.lru_width / n_model) * ab * 2  # f32 scan
        elif kind == "ssm":
            d_in = cfg.ssm_expand * d
            layer = 4 * A_res + 8 * T_loc * (d_in / n_model) * ab
            if cell.step == "decode":
                layer += B_loc * (d_in // cfg.ssm_head_dim) * cfg.ssm_state * cfg.ssm_head_dim / n_model * 4 * 2
        else:
            layer = 6 * A_res
        traffic += layer * act_mult

    # embeddings + logits (vocab sharded over model when divisible)
    v_shard = cfg.vocab_size / (n_model if cfg.vocab_size % n_model == 0 else 1)
    traffic += T_loc * d * ab + act_mult * T_loc * v_shard * 4

    return {
        "weight_bytes": weight_traffic,
        "activation_bytes": traffic,
        "total_bytes": weight_traffic + traffic,
    }


def model_flops(cfg, cell) -> float:
    """The reference's MODEL_FLOPS: 6 N_active D for a train step, 2 N_active
    D forward only (prefill: D = B S tokens; decode: D = B)."""
    n = cfg.num_active_params()
    if cell.step == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.step == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch


def ssd_flops(T: int, H: int, P: int, N: int, q: int) -> float:
    """FLOPs of one chunked SSD scan at batch 1 over chunks of ``q`` steps:
    per chunk of n rows, C B^T over its n (n + 1) / 2 causal pairs once
    (it does not depend on the head), and per head S @ x over the same
    pairs plus the two N x P products (carried-in state, state update)."""
    flops = 0.0
    for t0 in range(0, T, q):
        n = min(q, T - t0)
        pairs = n * (n + 1) / 2
        flops += 2 * pairs * N + H * (2 * pairs * P + 4 * n * N * P)
    return flops


def step_flops(cfg, cell) -> float:
    """FLOPs of one step of ``cell`` on the whole batch: 2 a matmul
    parameter (the active ones, embedding gather and norms aside) a token,
    4 a causal attention pair a query head a head dim on every attention
    layer (a window, where ``cfg.local_window`` is shorter than the
    sequence, caps the pairs of every one of them), and the SSD scan's
    products (:func:`ssd_flops` at the model's chunk) on every ``ssm``
    layer; a train step is 3 forwards (the forward and twice that
    backward).  A decode step is one token a sequence over its whole
    context (state updates of 4 N P a head on ``ssm`` layers)."""
    B, S = cell.global_batch, cell.seq_len
    d, nq, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    counts = cfg.param_counts()
    matmul_params = cfg.num_active_params() - counts["norms"] - (0 if cfg.tie_embeddings else counts["embed"])
    n_attn = sum(1 for k_ in cfg.layer_kinds if k_ in _ATTN_KINDS)
    n_ssm = sum(1 for k_ in cfg.layer_kinds if k_ == "ssm")
    P_, N_ = cfg.ssm_head_dim, cfg.ssm_state
    if cell.step == "decode":
        ctx = min(S, cfg.local_window or S)
        flops = 2.0 * B * matmul_params + 4.0 * B * ctx * nq * hd * n_attn
        if n_ssm:
            flops += 4.0 * B * n_ssm * (cfg.ssm_expand * d // P_) * N_ * P_
        return flops
    m = 3 if cell.step == "train" else 1
    pairs = S * (S + 1) // 2 if not cfg.local_window or cfg.local_window >= S else S * cfg.local_window
    flops = 2.0 * m * B * S * matmul_params + m * 4.0 * B * pairs * nq * hd * n_attn
    if n_ssm:
        flops += m * B * n_ssm * ssd_flops(S, cfg.ssm_expand * d // P_, P_, N_, cfg.ssm_chunk)
    return flops


def roofline(
    cost: Dict[str, float],
    coll: Dict[str, Any],
    cfg,
    cell,
    n_devices: int,
    mesh_shape: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """Three roofline terms in seconds, per device and step: ``cost``'s
    per-device ``flops`` over :data:`PEAK_FLOPS`, the analytic HBM traffic
    (:func:`analytic_memory_bytes`) over :data:`HBM_BW`, ``coll``'s wire
    bytes over :data:`ICI_BW`; ``cost``'s ``bytes accessed`` is reported
    as ``memory_s_hlo``.  The traffic model is the reference's placement
    (:func:`analytic_memory_bytes`: the port's ``tp`` moves more).  A
    ``(16, 16)`` mesh's ``model`` group of 16 ranks spans two 8-card
    NVLink domains, and its collectives cross the slower network between
    them, so ``collective_s`` at that shape is a lower bound."""
    n_model = (mesh_shape or {}).get("model", 16)
    n_data = 1
    for a in ("pod", "data"):
        n_data *= (mesh_shape or {"data": n_devices // n_model}).get(a, 1)

    flops = cost.get("flops", 0.0)
    bytes_hlo = cost.get("bytes accessed", 0.0)
    mem_model = analytic_memory_bytes(cfg, cell, n_model, n_data)
    compute_s = flops / PEAK_FLOPS
    memory_s = mem_model["total_bytes"] / HBM_BW
    collective_s = coll["wire_bytes"] / ICI_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, cell)
    mf_per_dev = mf / n_devices
    step_s = max(terms.values())
    useful = mf_per_dev / flops if flops else 0.0
    roofline_frac = (mf_per_dev / PEAK_FLOPS) / step_s if step_s else 0.0
    return {
        **terms,
        "memory_s_hlo": bytes_hlo / HBM_BW,
        "memory_bytes_model": mem_model,
        "bottleneck": bottleneck,
        "model_flops_total": mf,
        "model_flops_per_device": mf_per_dev,
        "hlo_flops_per_device": flops,
        "useful_flop_ratio": useful,
        "roofline_fraction": roofline_frac,
        "control_share_of_wire": coll.get("control_share", 0.0),
    }


# ---------------------------------------------------------------------------
# the collectives of the port's step
# ---------------------------------------------------------------------------


class _Tally:
    """``parse_collectives``' accounting of issued collectives: result
    bytes per op, scaled to wire bytes by the ring factor of the group."""

    def __init__(self):
        self.per_op = {op: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0} for op in COLLECTIVES}
        self.wire = self.control = 0.0

    def add(self, op: str, nbytes: int, group: int, integer: bool = False, times: int = 1) -> None:
        for _ in range(times):
            ring = (group - 1) / group if group > 1 else 0.0
            wire = 2.0 * nbytes * ring if op == "all-reduce" else float(nbytes) if op == "collective-permute" \
                else nbytes * ring
            rec = self.per_op[op]
            rec["count"] += 1
            rec["result_bytes"] += int(nbytes)
            rec["wire_bytes"] += wire
            self.wire += wire
            if integer or nbytes <= CONTROL_BYTES_LIMIT:
                self.control += wire

    def result(self) -> Dict[str, Any]:
        return {"per_op": self.per_op, "wire_bytes": self.wire, "control_wire_bytes": self.control,
                "control_share": self.control / self.wire if self.wire else 0.0}


def shape_mesh(mesh_shape: Dict[str, int]):
    """A :class:`~repro_torch.launch.mesh.Mesh` of ``mesh_shape`` seen from
    rank 0, with no process groups and the meta device: what the placement
    rules read (``shape``, ``coords``) and nothing to run on."""
    import torch

    from repro_torch.launch.mesh import Mesh

    return Mesh(dict(mesh_shape), {a: 0 for a in mesh_shape}, {}, torch.device("meta"))


def _group(mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def _nbytes(shape, itemsize: int) -> int:
    return int(np.prod(shape)) * itemsize


def _act_bytes(cfg) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _moe_forward(t: _Tally, cfg, mesh, B: int, S: int, batch_axes, *, replay: bool = False) -> None:
    """The expert-parallel MoE body's forward collectives on (B, S, d)
    (``parallel.moe_parallel.make_sharded_moe_apply``).  ``replay``: the
    recompute of a rematerialized layer, which checkpoint's early stop ends
    at the body's last op that saves a tensor for the backward (the
    ``a2a`` body's combine, the ``psum`` body's expert pair, or its shared
    experts after the sum): the ``a2a`` body's output gather and the aux
    mean are not issued again, nor the ``psum`` body's sum without shared
    experts."""
    from repro_torch.core.control_plane import capacity_for

    ep, d, ab = mesh.shape["model"], cfg.d_model, _act_bytes(cfg)
    E, k, shared = cfg.num_experts, cfg.top_k, bool(cfg.num_shared_experts)
    if S % ep == 0 and S >= ep:
        C = capacity_for(B * S // ep, E, k, cfg.capacity_factor)
        t.add("all-to-all", E * C * d * ab, ep, times=2)
        if not replay:
            t.add("all-gather", B * S * d * ab, ep)
            t.add("all-reduce", 8, _group(mesh, tuple(batch_axes) + ("model",)))
        return
    if not replay or shared:
        t.add("all-reduce", B * S * d * ab, ep)
    if batch_axes and not replay:
        t.add("all-reduce", 8, _group(mesh, batch_axes))


def _moe_backward(t: _Tally, cfg, mesh, B: int, S: int, p_moe: Dict[str, Any]) -> None:
    """The MoE body's backward collectives: the ``a2a`` body's exchanges,
    the router's and the shared experts' gradient sums over ``model`` (each
    rank routes its own chunk) and the gathers of its two split inputs'
    gradients; the ``psum`` body's gather of the slot weights' gradient and
    the sum of the input's."""
    from repro_torch.core.control_plane import capacity_for

    ep, d, ab = mesh.shape["model"], cfg.d_model, _act_bytes(cfg)
    E, k = cfg.num_experts, cfg.top_k
    pb = 2 if cfg.param_dtype == "bfloat16" else 4
    if S % ep == 0 and S >= ep:
        C = capacity_for(B * S // ep, E, k, cfg.capacity_factor)
        t.add("all-to-all", E * C * d * ab, ep, times=2)
        t.add("all-reduce", _nbytes(p_moe["router"].shape, pb), ep)
        for leaf in (p_moe.get("shared") or {}).values():
            t.add("all-reduce", _nbytes(leaf.shape, pb), ep)
        t.add("all-gather", B * S * d * ab, ep, times=2)
        return
    C = capacity_for(B * S, E, k, cfg.capacity_factor)
    t.add("all-gather", E * C * 4, ep)
    t.add("all-reduce", B * S * d * ab, ep)


def _train_collectives(t: _Tally, cfg, cell, mesh, strategy: str) -> None:
    """What one ``_MeshTrainStep`` call issues on a rank (its docstring):
    the gathers on use (top-level leaves once a forward, a layer's at each
    call, again in the recompute under remat; under ``fsdp`` each gather's
    reduce-scatter in the backward), the ``tp`` MoE body, the gradient
    mean, the global norm's sums, Adafactor's statistics over split axes,
    and the metrics' mean."""
    from repro_torch.launch.steps import train_batch_axes
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import _walk, scan_of
    from repro_torch.parallel.sharding import is_expert_stack, param_pspecs, placement

    tp = strategy == "tp"
    shapes = T.init_params(cfg, None, "meta", train=True)
    specs = param_pspecs(shapes, mesh, strategy=strategy)
    pb = shapes["embed"].element_size()
    batch_axes = train_batch_axes(cell.global_batch, mesh, strategy)
    B, S = cell.global_batch // _group(mesh, batch_axes), cell.seq_len
    pat = cfg.block_pattern
    n_rem = cfg.num_layers // len(pat) * len(pat) if cfg.remat else 0  # layers inside checkpointed blocks

    def leaf_info(path, leaf):
        spec = specs
        for key in path:
            spec = spec[key]
        pl = placement(spec, mesh)
        shard = list(leaf.shape)
        if pl is not None:
            shard[pl.dim] //= pl.size
        return pl, tuple(shard)

    info = {path: leaf_info(path, leaf) for path, leaf in _walk(shapes)}

    def gathers(tree, prefix, times):
        for path, leaf in _walk(tree, path=prefix):
            pl, shard = info[path]
            if pl is None or (tp and is_expert_stack(path, tuple(leaf.shape))):
                continue
            t.add("all-gather", _nbytes(leaf.shape, pb), pl.size, times=times)
            if not tp:
                t.add("reduce-scatter", _nbytes(shard, pb), pl.size)

    # forward (and the backward's reduce-scatters of each gather)
    gathers({k: v for k, v in shapes.items() if k != "layers"}, (), 1)
    moe_tp = tp and cfg.is_moe
    for i, kind in enumerate(cfg.layer_kinds):
        gathers(shapes["layers"][i], ("layers", i), 2 if i < n_rem else 1)
        if kind == "moe" and moe_tp:
            _moe_forward(t, cfg, mesh, B, S, batch_axes)
            if i < n_rem:
                _moe_forward(t, cfg, mesh, B, S, batch_axes, replay=True)
            _moe_backward(t, cfg, mesh, B, S, shapes["layers"][i]["moe"])

    # the gradients' mean
    for path, leaf in _walk(shapes):
        pl, shard = info[path]
        if tp:
            axes = ["data"] + (["pod"] if "pod" in mesh.shape else [])
        else:
            axes = [a for a in mesh.axis_names if pl is None or a not in pl.axes]
        for a in axes:
            t.add("all-reduce", _nbytes(shard, pb), mesh.shape[a])

    # the global norm: one sum a group of split leaves
    n_leaves = len(info)
    for axes in sorted({pl.axes for pl, _ in info.values() if pl is not None and pl.size > 1}):
        t.add("all-reduce", 4 * n_leaves, _group(mesh, axes))

    if cfg.optimizer == "adafactor":
        _adafactor_collectives(t, info, scan_of(cfg), shapes)

    metric_axes = [a for a in mesh.axis_names if a != "model"] if tp else list(mesh.axis_names)
    if _group(mesh, metric_axes) != 1:
        for a in metric_axes:
            t.add("all-reduce", 4 * _METRICS, mesh.shape[a])


def _adafactor_collectives(t: _Tally, info, scan, shapes) -> None:
    """Adafactor's sums over a split leaf's group (``optim.optimizers.
    adafactor``'s ``update``): a row or column mean along the split axis,
    the row mean's mean along it, and the update's RMS."""
    from repro_torch.optim.optimizers import _groups

    for stacked, items in _groups(scan, shapes):
        path0 = items[0][0]
        pl, shard = info[path0]
        if pl is None or pl.size == 1:
            continue
        g, dim, nd = pl.size, pl.dim, len(shard)
        if stacked and nd == 1:
            t.add("all-reduce", 4, g, times=len(items) + 1)  # each layer's mean of g^2, then the RMS
            continue
        for _ in items:
            if nd >= 2:
                if dim == nd - 1:
                    t.add("all-reduce", 4 * int(np.prod(shard[:-1])), g)
                if dim == nd - 2:
                    t.add("all-reduce", 4 * int(np.prod(shard[:-2] + shard[-1:])), g)
        # the unclipped update (once for the RMS of a stack, once to apply)
        row_mean = nd >= 2 and dim == nd - 2
        calls = 2 * len(items) if len(items) > 1 else 1
        if row_mean:
            t.add("all-reduce", 4 * int(np.prod(shard[:-2])), g, times=calls)
        t.add("all-reduce", 4, g)  # the RMS


def _serve_batch(cell, mesh) -> Tuple[int, bool]:
    """(this rank's slots, split) of a serving cell: the slots split over
    the data axes that divide them (``parallel.sharding.batch_axes``)."""
    from repro_torch.parallel.sharding import batch_axes

    n = _group(mesh, batch_axes(cell.global_batch, mesh))
    return cell.global_batch // n, n > 1


def collective_bytes(cfg, cell, mesh_shape: Dict[str, int], strategy: str = "tp") -> Dict[str, Any]:
    """Per-rank, per-step collectives of the port's own step on a mesh of
    ``mesh_shape``, in ``parse_collectives``' form (``per_op`` under the
    five names with ``count``, ``result_bytes`` and ``wire_bytes``;
    ``wire_bytes``, ``control_wire_bytes``, ``control_share``), with the
    reference's ring factors (all-reduce 2 (g - 1) / g, the others
    (g - 1) / g) and its control rule.  Every collective the step issues
    is counted, over a one-rank group too (its wire bytes are 0).

    * train (``launch.steps.build_train_step``, ``strategy``): see
      :func:`_train_collectives`;
    * prefill: the MoE layers' expert-parallel body, forward only;
    * decode: one ``all_reduce`` of each MoE layer's (B T, d) f32 output
      over ``model`` when it has more than one rank
      (``parallel.moe_parallel.make_sharded_decode_apply``), and, when the
      slots split over ``data``, the launch's control words: the verified
      ids (B_loc, T) int32 gathered over the data group
      (``launch.serve.ServeReplica``; a model drafter's draft tokens add
      one more gather of the same size)."""
    mesh = shape_mesh(mesh_shape)
    t = _Tally()
    if cell.step == "train":
        _train_collectives(t, cfg, cell, mesh, strategy)
        return t.result()
    n_moe = sum(1 for k_ in cfg.layer_kinds if k_ == "moe")
    ep = mesh.shape["model"]
    B, split = _serve_batch(cell, mesh)
    if cell.step == "prefill":
        if n_moe and ep > 1:
            for _ in range(n_moe):
                _moe_forward(t, cfg, mesh, B, cell.seq_len, ())
        return t.result()
    T = max(int(cfg.spec_tokens), 1)
    if n_moe and ep > 1:
        t.add("all-reduce", B * T * cfg.d_model * 4, ep, times=n_moe)
    if split:
        data = _group(mesh, [a for a in ("pod", "data") if a in mesh.shape])
        t.add("all-gather", B * data * T * 4, data, integer=True)
    return t.result()
