"""Agile PE Assignment (paper §4.3, Fig. 8; the port's own copy of
``repro/core/agile.py``, pure Python on the host).

Two algorithms:

* :func:`time_extend_mapping` — the paper's scheduling algorithm: map BBs of
  each loop level, then *time-extend* (fold spatial mappings into the
  temporal domain) so every BB of an imperfect loop nest shares the fabric
  proportionally to its dynamic work, minimizing PE waste.
* :func:`assign_stages` — contiguous balanced partition of heterogeneous
  model blocks onto pipeline stages (min-max stage cost DP); the framework's
  realization of agile assignment for hybrid stacks (e.g. RecurrentGemma's
  1:2 attn:recurrent pattern, MoE-every-k).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cdfg import BasicBlock, CDFG
from repro_torch.core.plans import StagePlan


@dataclass(frozen=True)
class Assignment:
    """Result of time-extension: per-BB PE share + fold factor."""

    pes: Dict[str, int]          # BB name -> #PEs assigned
    fold: Dict[str, int]         # BB name -> time-extension factor
    makespan: float              # steady-state time per outermost iteration
    utilization: float           # total work / (N_pes * makespan)
    pe_waste: Dict[str, int]     # BB name -> idle PE-slots per fold round


def _fold_for(n_ops: int, pes: int) -> int:
    return max(1, math.ceil(n_ops / max(pes, 1)))


def _steady(b: BasicBlock, p: int) -> float:
    """Steady-state time of BB ``b`` mapped on ``p`` PEs per outermost iter.

    p <= n_ops: time-extended (folded) — local II multiplied by the fold.
    p >  n_ops: replicated inner pipelines (only if iterations are parallel) —
    the paper's "reconfigure outer-BB PEs as inner loop pipelines" (Fig. 15).
    """
    if p < b.n_ops:
        return b.trip_count * _fold_for(b.n_ops, p) * b.ii
    if b.parallel and p >= 2 * b.n_ops:
        return b.trip_count * b.ii / (p // b.n_ops)
    return b.trip_count * b.ii


def _next_target(b: BasicBlock, p: int) -> Optional[int]:
    """Smallest PE count > p that strictly reduces ``_steady`` (fold boundary
    below n_ops, replica boundary above), or None if saturated."""
    if p < b.n_ops:
        cur_fold = _fold_for(b.n_ops, p)
        if cur_fold > 1:
            return min(math.ceil(b.n_ops / (cur_fold - 1)), b.n_ops)
        return b.n_ops  # unreachable (fold==1 implies p>=n_ops)
    if b.parallel:
        return (p // b.n_ops + 1) * b.n_ops
    return None


def time_extend_mapping(cdfg: CDFG, n_pes: int) -> Assignment:
    """Greedy water-filling realization of Fig. 8.

    Every BB starts with 1 PE (maximally folded).  Repeatedly grant PEs to
    the BB whose steady-state time is largest, jumping to the next fold or
    replication boundary — the paper's reshape-selection rule "select the
    mapping scheme that minimizes PE waste" applied iteratively: each grant
    maximally reduces the pipeline's dominant term.
    """
    blocks = [b for b in cdfg.blocks if b.n_ops > 0]
    if not blocks:
        return Assignment({}, {}, 0.0, 0.0, {})
    if n_pes < len(blocks):
        raise ValueError(f"need >= {len(blocks)} PEs for {cdfg.name} (one per BB)")

    pes = {b.name: 1 for b in blocks}
    spare = n_pes - len(blocks)

    while spare > 0:
        # Rank by current steady time, descending; take the first BB whose
        # next boundary is affordable.
        order = sorted(blocks, key=lambda b: _steady(b, pes[b.name]), reverse=True)
        granted = False
        for b in order:
            tgt = _next_target(b, pes[b.name])
            if tgt is None:
                continue
            need = tgt - pes[b.name]
            if 0 < need <= spare and _steady(b, tgt) < _steady(b, pes[b.name]):
                pes[b.name] = tgt
                spare -= need
                granted = True
                break
        if not granted:
            break

    fold = {b.name: _fold_for(b.n_ops, pes[b.name]) for b in blocks}
    makespan = max(_steady(b, pes[b.name]) for b in blocks)
    total_work = sum(b.work for b in blocks)
    util = total_work / (n_pes * makespan) if makespan else 0.0
    waste = {b.name: max(pes[b.name] * fold[b.name] - b.n_ops, 0) for b in blocks}
    return Assignment(pes=pes, fold=fold, makespan=makespan, utilization=min(util, 1.0), pe_waste=waste)


def static_spatial_mapping(cdfg: CDFG, n_pes: int) -> Assignment:
    """The von-Neumann baseline: fully spatial per-BB mapping (fold = 1),
    PEs statically owned by their BB — idle whenever that BB isn't executing.
    If the CDFG doesn't fit, whole BBs time-multiplex through the CCU
    (reconfiguration charged by the simulator, not here).
    """
    blocks = [b for b in cdfg.blocks if b.n_ops > 0]
    pes = {b.name: b.n_ops for b in blocks}
    fold = {b.name: 1 for b in blocks}
    makespan = max((b.trip_count * b.ii for b in blocks), default=0.0)
    total_work = sum(b.work for b in blocks)
    util = total_work / (n_pes * makespan) if makespan else 0.0
    return Assignment(pes, fold, makespan, min(util, 1.0), {b.name: 0 for b in blocks})


# ---------------------------------------------------------------------------
# Pipeline stage assignment (framework side)
# ---------------------------------------------------------------------------


def assign_stages(costs: Sequence[float], num_stages: int) -> StagePlan:
    """Contiguous partition of per-block costs into ``num_stages`` stages
    minimizing the max stage cost (pipeline II).  O(n^2 * s) DP — n is a layer
    count (<= hundreds).

    This is Agile PE Assignment at pod granularity: light blocks are folded
    together onto one stage (time-extension), heavy blocks get stages to
    themselves, so heterogeneous stacks pipeline with minimal "PE waste"
    (= stage idle time).
    """
    n = len(costs)
    if num_stages <= 0:
        raise ValueError("num_stages must be positive")
    num_stages = min(num_stages, n) if n else num_stages
    if n == 0:
        return StagePlan(boundaries=(), fold=(), cost=())
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + float(c))

    def seg(i: int, j: int) -> float:  # cost of blocks [i, j)
        return prefix[j] - prefix[i]

    INF = float("inf")
    # dp[s][j] = min over partitions of first j blocks into s stages of max stage cost
    dp = [[INF] * (n + 1) for _ in range(num_stages + 1)]
    cut = [[0] * (n + 1) for _ in range(num_stages + 1)]
    dp[0][0] = 0.0
    for s in range(1, num_stages + 1):
        for j in range(s, n + 1):
            best, arg = INF, s - 1
            for i in range(s - 1, j):
                v = max(dp[s - 1][i], seg(i, j))
                if v < best:
                    best, arg = v, i
            dp[s][j] = best
            cut[s][j] = arg
    # Recover boundaries.
    bounds: List[Tuple[int, int]] = []
    j = n
    for s in range(num_stages, 0, -1):
        i = cut[s][j]
        bounds.append((i, j))
        j = i
    bounds.reverse()
    stage_costs = tuple(seg(i, j) for i, j in bounds)
    fold = tuple(j - i for i, j in bounds)  # blocks folded per stage
    return StagePlan(boundaries=tuple(bounds), fold=fold, cost=stage_costs)


def block_costs_for_model(cfg, seq_len: int) -> List[Tuple[str, float]]:
    """Per-layer FLOP cost estimates (forward, per token-batch of 1) used by
    the pipeline runtime to drive :func:`assign_stages`.
    """
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    out: List[Tuple[str, float]] = []
    for kind in cfg.layer_kinds:
        if kind in ("attn", "local", "moe"):
            qkv = 2 * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
            o = 2 * cfg.num_heads * hd * d
            ctx = min(seq_len, cfg.local_window or seq_len)
            attn = 4 * cfg.num_heads * hd * ctx  # qk^T + av per token
            if kind == "moe":
                dff = cfg.d_ff_expert or cfg.d_ff
                ffn = 6 * d * dff * (cfg.top_k + cfg.num_shared_experts)
                ffn += 2 * d * cfg.num_experts  # router
            else:
                ffn = 6 * d * cfg.d_ff
            out.append((kind, float(qkv + o + attn + ffn)))
        elif kind == "rec":
            w = cfg.lru_width
            out.append((kind, float(2 * d * w * 2 + 2 * w * cfg.conv1d_width + 8 * w + 2 * w * d + 6 * d * cfg.d_ff)))
        elif kind == "ssm":
            di = cfg.ssm_expand * d
            out.append((kind, float(2 * d * 2 * di + 2 * di * cfg.conv1d_width + 4 * di * cfg.ssm_state + 2 * di * d)))
        else:
            raise ValueError(kind)
    return out
