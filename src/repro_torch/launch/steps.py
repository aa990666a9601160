"""The serve launches as plain eager functions (the port's counterpart of
``repro/launch/steps.py``'s ``build_spec_serve_step`` and
``build_admission``, which build jitted, sharded bundles), and
:func:`build_model`, which binds a model to a mesh.

CUDA graphs for the decode launch come in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plans import TreePlan
from repro_torch.models.layers import Params
from repro_torch.models.model import Model
from repro_torch.parallel.moe_parallel import make_sharded_decode_apply, make_sharded_moe_apply
from repro_torch.parallel.sharding import batch_spec, expert_slice


def build_model(cfg: ModelConfig, mesh, batch: int, device=None) -> Model:
    """A model whose MoE layers run on ``mesh``: the expert-parallel prefill
    apply, and on the decode plane the shard-sliced decode apply (which
    raises, not falls back, when the experts do not divide the ``model``
    axis), as the reference's ``build_model`` binds them.  The batch axes
    are the data axes that divide ``batch``.  No dense layer is sharded, so
    the reference's residual constraint is the identity here.  ``mesh=None``
    is the single-host model on ``device``; with a mesh the model lives on
    the mesh's device and its ``init`` draws this rank's expert slice."""
    if mesh is None:
        return Model(cfg, device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    baxes = batch_spec(batch, mesh)[0] or ()
    baxes = (baxes,) if isinstance(baxes, str) else tuple(baxes)
    moe_apply = decode_apply = None
    if cfg.is_moe:
        moe_apply = make_sharded_moe_apply(cfg, mesh, baxes)
        if cfg.decode_plane:
            decode_apply = make_sharded_decode_apply(cfg, mesh, baxes)
    return Model(cfg, mesh.device, moe_apply=moe_apply, decode_moe_apply=decode_apply,
                 experts=expert_slice(cfg, mesh) if cfg.is_moe else None)


def spec_serve_step(
    model: Model, params: Params, cache: List[Params], tokens: np.ndarray, lengths: np.ndarray,
    prev_accept: np.ndarray, *, tree: Optional[TreePlan] = None, pages: Optional[np.ndarray] = None,
    commit: Optional[Tuple[np.ndarray, np.ndarray]] = None, telemetry: bool = False,
    max_len: Optional[int] = None,
) -> Tuple[np.ndarray, Optional[float]]:
    """One speculative launch: tokens (B, T), lengths (B,), prev_accept (B,),
    and under the paged plane the block table (B, max_pages) and, for
    branchy trees, the previous round's commit maps ``(dst, src)`` -> (the
    model's greedy token per position (B, T) on the host, the plan agreement
    or None).  ``max_len`` is the slot budget positions are checked against
    when no layer holds a full-length cache (rolling windows, ``rec``
    state).  The argmax runs on the device, so only B*T ids cross to the
    host; the cache is updated in place."""
    out = model.decode_tokens(params, cache, tokens, lengths, prev_accept, telemetry=telemetry, tree=tree,
                              pages=pages, commit=commit, max_len=max_len)
    logits, metrics = out if telemetry else (out, None)
    y = torch.argmax(logits, dim=-1).cpu().numpy()
    return y, (metrics["plan_agreement"] if telemetry else None)


def prefill_model(model: Model) -> Model:
    """The B=1 admission prefill's model: under ``cfg.paged`` a contiguous
    twin with the same MoE applies (prefill writes stripes; the pool is
    seeded by a row scatter)."""
    if not model.cfg.paged:
        return model
    return Model(dataclasses.replace(model.cfg, paged=False), model.device, moe_apply=model.moe_apply,
                 decode_moe_apply=model.decode_moe_apply, experts=model.experts)


def admission(
    model: Model, params: Params, cache: List[Params], prompt: np.ndarray, slot: int,
    rows: Optional[np.ndarray] = None, pf_model: Optional[Model] = None,
) -> torch.Tensor:
    """B=1 prefill of ``prompt`` into batch row ``slot`` -> last-position
    logits (V,).

    Contiguous: the prefill writes straight into the slot (the reference
    prefills a fresh B=1 cache and copies it in; the slot ends up holding
    the same rows).  Paged (``rows`` given, the (max_len,) physical-row
    vector of the replica's page binding): a contiguous B=1 prefill into a
    fresh cache of ``pf_model`` (see :func:`prefill_model`), then only the
    rows the vector names are written into the pool."""
    prompt = np.asarray(prompt)[None]
    if rows is None:
        return model.prefill(params, prompt, cache, slot=slot)[0]
    pf_model = pf_model or prefill_model(model)
    one = pf_model.init_cache(1, len(rows))
    logits = pf_model.prefill(params, prompt, one)[0]
    model.write_cache_slot_paged(cache, one, slot, rows)
    return logits
