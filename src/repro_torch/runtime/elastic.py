"""Elastic re-shard after losing ranks (port of ``repro/runtime/elastic.py``):
rebuild the mesh of the survivors and restore the training state onto it.

The ``model`` axis is kept (the parameter placement stays valid); ``data``
shrinks to what the survivors hold.  The checkpoint holds whole leaves, so
each survivor cuts its shards of the new mesh from them
(:meth:`~repro_torch.checkpoint.manager.CheckpointManager.restore` with the
mesh and strategy), and the data loader's determinism contract lets the
stream resume at the restored step.  Every survivor calls
:func:`reshard_after_failure` with the same arguments (its own ``rank``).
The serve fabric's counterpart, :func:`reshard_serve_after_failure`,
restores the params alone (serving keeps no optimizer state).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.mesh import Mesh, elastic_mesh
from repro_torch.launch.steps import build_train_step


class LeftMesh(Exception):
    """This rank is not one of the survivors' mesh: it stops serving (the
    serve CLI exits 0 on it)."""


@dataclass
class ElasticState:
    mesh: Mesh
    step_fn: Any    # the sharded train step on the new mesh
    params: Any     # this rank's shards
    opt_state: Any
    step: int


def reshard_after_failure(
    cfg,
    cell,
    ckpt: CheckpointManager,
    *,
    n_healthy: int,
    model_axis: Optional[int] = None,
    device=None,
    strategy: str = "tp",
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    lr: float = 3e-4,
    total_steps: int = 10_000,
) -> ElasticState:
    """Rebuild the largest ``(data, model)`` mesh of ``n_healthy`` ranks
    (``model_axis`` kept, 1 by default; :func:`~repro_torch.launch.mesh.
    elastic_mesh`, which with ``init_method`` and ``rank`` first makes the
    survivors' fresh default group) and restore the latest committed step
    of ``ckpt`` (a ``train`` manager of ``cfg``) as this rank's shards on
    it."""
    mesh = elastic_mesh(n_healthy, model=model_axis or 1, device=device, init_method=init_method, rank=rank)
    step_fn = build_train_step(cfg, mesh, cell, lr=lr, total_steps=total_steps, strategy=strategy)
    params, opt_state, step, _ = ckpt.restore(mesh.device, mesh=mesh, strategy=strategy)
    return ElasticState(mesh=mesh, step_fn=step_fn, params=params, opt_state=opt_state, step=step)


@dataclass
class ServeElasticState:
    """A serve replica's world after a failure: the survivors' mesh, the
    params restored from the latest committed checkpoint as this rank's
    share of it, the checkpoint's step and its ``extra`` (the fabric's
    admission ledger).  The reference also carries the new mesh's compiled
    serve step (a ``StepBundle``); the port has none: the replica built on
    the mesh compiles its own launches."""

    mesh: Mesh
    params: Any
    step: int
    extra: dict


def reshard_serve_after_failure(
    cfg,
    cell,
    ckpt: CheckpointManager,
    *,
    n_healthy: int,
    model_axis: Optional[int] = None,
    device=None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
) -> ServeElasticState:
    """The serve fabric's twin of :func:`reshard_after_failure`: the largest
    ``(data, model)`` mesh of ``n_healthy`` ranks (``model_axis`` kept, 1
    by default; :func:`~repro_torch.launch.mesh.elastic_mesh`, which with
    ``init_method`` and ``rank`` first makes the survivors' fresh default
    group) and the params alone of the latest committed step of ``ckpt``
    (a manager of ``cfg``), this rank's expert slice on the new mesh's
    device.  ``cell`` (the replica's decode shape) is the reference's
    argument and sets nothing here.  The decode cache is never
    checkpointed: the rejoining replica re-warms it by replaying the
    admissions the fabric re-admits."""
    del cell
    mesh = elastic_mesh(n_healthy, model=model_axis or 1, device=device, init_method=init_method, rank=rank)
    params, _, step, extra = ckpt.restore(mesh.device, mesh=mesh)
    return ServeElasticState(mesh=mesh, params=params, step=step, extra=extra)
