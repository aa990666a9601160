"""Pipeline-parallel planning: Agile PE Assignment at pod granularity (the
port's own copy of ``repro/parallel/pipeline.py``; an analytic 1F1B
estimate on the host, no ranks).

The paper's scheduler rebalances basic blocks of an imperfect loop nest onto
PEs (fold light BBs, give heavy BBs the fabric).  At pod scale the same
problem appears when a heterogeneous layer stack (RecurrentGemma's 1:2
rec:attn pattern, MoE-every-k, frontend blocks) must be cut into pipeline
stages: naive equal-depth cuts leave the light stages idle (the paper's "PE
waste" = stage bubble).  ``plan_pipeline`` derives per-layer costs from the
config, partitions them with the min-max DP from
:mod:`repro_torch.core.agile`, and returns the stage plan plus a 1F1B
schedule estimate beside the naive cut's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.agile import assign_stages, block_costs_for_model
from repro_torch.core.plans import StagePlan


@dataclass(frozen=True)
class PipelineEstimate:
    plan: StagePlan
    num_microbatches: int
    # steady-state 1F1B estimate, cost units = per-microbatch block cost
    total_time: float
    bubble_fraction: float
    utilization: float


def naive_stage_plan(costs: Sequence[float], num_stages: int) -> StagePlan:
    """Equal-layer-count cut (what a depth-only splitter does)."""
    n = len(costs)
    per = -(-n // num_stages)
    bounds = []
    i = 0
    while i < n:
        bounds.append((i, min(i + per, n)))
        i += per
    stage_costs = tuple(sum(costs[a:b]) for a, b in bounds)
    return StagePlan(boundaries=tuple(bounds), fold=tuple(b - a for a, b in bounds), cost=stage_costs)


def estimate_1f1b(plan: StagePlan, num_microbatches: int) -> PipelineEstimate:
    """1F1B steady state: total = (M - 1) * II + sum(stage costs) for the
    fill/drain ramps, with II = max stage cost (fwd+bwd ~ 3x fwd folded into
    the unit)."""
    s = plan.num_stages
    ii = plan.ii
    fill = sum(plan.cost)
    total = fill + (num_microbatches - 1) * ii
    ideal = sum(plan.cost) * num_microbatches / max(s, 1)
    util = min(1.0, ideal / total) if total else 0.0
    return PipelineEstimate(
        plan=plan,
        num_microbatches=num_microbatches,
        total_time=total,
        bubble_fraction=1.0 - util,
        utilization=util,
    )


def plan_pipeline(
    cfg,
    seq_len: int,
    num_stages: int,
    num_microbatches: int = 8,
) -> Dict[str, PipelineEstimate]:
    """Agile vs naive stage assignment for a model config.

    Returns {"agile": ..., "naive": ...} 1F1B estimates; the agile plan's
    bubble_fraction is the framework analogue of Fig. 14's speedup source.
    """
    costs = [c for _, c in block_costs_for_model(cfg, seq_len)]
    agile = assign_stages(costs, num_stages)
    naive = naive_stage_plan(costs, num_stages)
    return {
        "agile": estimate_1f1b(agile, num_microbatches),
        "naive": estimate_1f1b(naive, num_microbatches),
    }
