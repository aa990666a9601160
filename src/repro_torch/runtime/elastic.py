"""Elastic re-shard after losing ranks (port of ``repro/runtime/elastic.py``):
rebuild the mesh of the survivors and restore the training state onto it.

The ``model`` axis is kept (the parameter placement stays valid); ``data``
shrinks to what the survivors hold.  The checkpoint holds whole leaves, so
each survivor cuts its shards of the new mesh from them
(:meth:`~repro_torch.checkpoint.manager.CheckpointManager.restore` with the
mesh and strategy), and the data loader's determinism contract lets the
stream resume at the restored step.  Every survivor calls
:func:`reshard_after_failure` with the same arguments (its own ``rank``).
The serve fabric's counterpart (``ServeElasticState``,
``reshard_serve_after_failure``) comes with the serve data axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.mesh import Mesh, elastic_mesh
from repro_torch.launch.steps import build_train_step


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
