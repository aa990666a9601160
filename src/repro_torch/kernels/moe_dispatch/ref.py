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


def combine(y_slots: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    return _combine(y_slots.to(torch.float32), plan).to(y_slots.dtype)
