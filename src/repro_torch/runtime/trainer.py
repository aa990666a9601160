"""Fault-tolerant training loop (the port's counterpart of
``repro/runtime/trainer.py``).

The step comes from :func:`repro_torch.launch.steps.build_train_step`;
around it the trainer provides periodic atomic checkpoints (the port's
:class:`CheckpointManager`, in the reference's on-disk format: params and
the optimizer state under the reference's leaf names), failure injection
and restart from the latest committed checkpoint, straggler observation and
metric logging.  On an injected failure the trainer restores the latest
checkpoint (or re-initializes when there is none yet), seeks the
deterministic data stream back to that step and replays from there.

Given a :class:`~repro_torch.launch.mesh.Mesh` instead of a device (as the
reference's Trainer takes a mesh) every rank runs the loop: the sharded
step (``TrainerConfig.strategy``, ``tp`` or ``fsdp``), its rows of each
global batch, checkpoints gathered to rank 0 and restored as this mesh's
shards, and the injected failures (a deterministic schedule, so every rank
fails and restarts at the same step).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.data import MarkovLMDataset, ShardedLoader
from repro_torch.launch.steps import build_train_step
from repro_torch.models.layers import Params
from repro_torch.runtime.straggler import StragglerDetector


class FailureInjector:
    """Deterministic fault schedule: raise at given steps (once each)."""

    def __init__(self, fail_at: Optional[List[int]] = None):
        self.fail_at = set(fail_at or [])
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclass
class TrainerConfig:
    num_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every: int = 10
    lr: float = 3e-4
    seed: int = 0
    strategy: str = "tp"  # on a mesh: "tp" or "fsdp"


class Trainer:
    """The reference's Trainer on one device (``device=None`` means the
    card) or on a mesh (every rank constructs it and calls :meth:`run`).
    ``init_params`` makes the starting weights, whole (default:
    ``Model.init(tcfg.seed, train=True)``; on a mesh each rank keeps its
    shards); it is called again on a restart that finds no checkpoint, so
    it must make the same weights each time.
    ``run`` returns ``{"final_step", "restarts", "final_loss", "metrics"}``,
    ``metrics`` one dict per executed step (replayed steps appear again)."""

    def __init__(
        self,
        cfg: ModelConfig,
        cell: ShapeCell,
        device_or_mesh,
        tcfg: TrainerConfig,
        *,
        dataset=None,
        failure_injector: Optional[FailureInjector] = None,
        on_metrics: Optional[Callable[[int, Dict], None]] = None,
        init_params: Optional[Callable[[], Params]] = None,
    ):
        self.cfg, self.cell, self.tcfg = cfg, cell, tcfg
        self.mesh = device_or_mesh if hasattr(device_or_mesh, "axis_names") else None
        self.device = self.mesh.device if self.mesh is not None else resolve_device(device_or_mesh)
        self.step_fn = build_train_step(cfg, self.mesh or self.device, cell, lr=tcfg.lr, total_steps=tcfg.num_steps,
                                        strategy=tcfg.strategy)
        self.model = self.step_fn.model
        self.init_params = init_params or (lambda: self.model.init(tcfg.seed, train=True))
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints, cfg=cfg, train=True)
        self._placed = dict(mesh=self.mesh, strategy=tcfg.strategy) if self.mesh is not None else {}
        self.injector = failure_injector or FailureInjector()
        self.on_metrics = on_metrics
        self.detector = StragglerDetector(n_workers=1)
        self.dataset = dataset or MarkovLMDataset(cfg.vocab_size, cell.seq_len, seed=tcfg.seed)
        self.metrics_log: List[Dict] = []
        self.restarts = 0

    # ------------------------------------------------------------------
    def _init_state(self):
        params = self.init_params()
        if self.mesh is not None:
            params = self.step_fn.shard(params)
        return params, self.step_fn.optimizer.init(params), 0

    def _restore_or_init(self):
        if self.ckpt.latest_step() is None:
            return self._init_state()
        params, opt_state, step, _ = self.ckpt.restore(self.device, **self._placed)
        return params, opt_state, step

    # ------------------------------------------------------------------
    def run(self, num_steps: Optional[int] = None) -> Dict[str, Any]:
        total = num_steps or self.tcfg.num_steps
        params, opt_state, start = self._restore_or_init()
        frontend_spec = (
            (self.cfg.frontend_tokens, self.cfg.frontend_dim) if self.cfg.frontend else None
        )
        loader = ShardedLoader(
            self.dataset, self.cell.global_batch, self.device,
            start_step=start, frontend_spec=frontend_spec,
            rows=self.step_fn.rows if self.mesh is not None else None,
        )
        step = start
        try:
            while step < total:
                try:
                    data_step, batch = next(loader)
                    assert data_step == step, f"stream desync: {data_step} != {step}"
                    self.injector.maybe_fail(step)
                    t0 = time.perf_counter()
                    params, opt_state, _, metrics = self.step_fn(
                        params, opt_state, step, batch["tokens"], batch.get("frontend"))
                    metrics = {k: float(v) for k, v in metrics.items()}  # one read back a step
                    dt = time.perf_counter() - t0
                    self.detector.observe(np.full(1, dt))
                    step += 1
                    metrics["step_time_s"] = dt
                    self.metrics_log.append({"step": step, **metrics})
                    if self.on_metrics and step % self.tcfg.log_every == 0:
                        self.on_metrics(step, metrics)
                    if step % self.tcfg.checkpoint_every == 0 or step == total:
                        self.ckpt.save(step, params, opt_state, {"loss": metrics.get("loss")}, **self._placed)
                except RuntimeError as e:
                    if "injected node failure" not in str(e):
                        raise
                    # restart-from-checkpoint path
                    self.restarts += 1
                    del params, opt_state
                    params, opt_state, step = self._restore_or_init()
                    loader.seek(step)
        finally:
            loader.close()
        return {
            "final_step": step,
            "restarts": self.restarts,
            "final_loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
            "metrics": self.metrics_log,
        }
