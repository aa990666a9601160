"""Straggler detection & mitigation policy (the port's own copy of
``repro/runtime/straggler.py``).

At pod scale a single slow chip serializes every collective (the pipeline's
II is set by the slowest participant — the spatial-architecture pathology the
paper's Agile PE Assignment addresses at PE granularity).  The detector keeps
per-worker EWMA step times and flags workers whose smoothed time exceeds
``threshold`` x the healthy median for ``patience`` consecutive steps; the
policy then decides between re-dispatching that worker's microbatch
(transient hiccup) and excluding the worker (persistent — trigger elastic
re-shard).
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Mitigation(enum.Enum):
    NONE = "none"
    REDISPATCH = "redispatch"   # retry the slow worker's shard this step
    EXCLUDE = "exclude"         # drop the worker; caller re-shards elastically


@dataclass
class StragglerDetector:
    n_workers: int
    alpha: float = 0.3          # EWMA smoothing
    threshold: float = 2.0      # x median EWMA => straggling
    patience: int = 3           # consecutive flagged steps before EXCLUDE
    warmup: int = 5             # steps before any verdicts (compile noise)
    # injected clock stamping the verdict log — monotonic in production, a
    # manual clock in tests, so flag timelines are reproducible; no policy
    # decision here ever reads wall time directly
    clock: Callable[[], float] = time.monotonic

    _ewma: Optional[np.ndarray] = field(default=None, init=False)
    _flagged: Optional[np.ndarray] = field(default=None, init=False)
    _steps: int = field(default=0, init=False)
    _primed: bool = field(default=False, init=False)
    # (clock timestamp, worker index, action value) per verdict
    flag_log: List[Tuple[float, int, str]] = field(default_factory=list, init=False)

    def __post_init__(self) -> None:
        self._ewma = np.zeros(self.n_workers)
        self._flagged = np.zeros(self.n_workers, np.int64)

    def rebase(self, survivors: Sequence[int]) -> None:
        """Re-shape the detector after an elastic membership change.

        ``survivors`` are the (current-indexing) worker indices that remain;
        their EWMA history carries over to the new compact indices while the
        flag counters reset and warmup restarts — after an ``EXCLUDE`` +
        re-shard the fleet must be re-measured before new verdicts (step
        times change when the survivors absorb the excluded worker's load).
        Without this the detector would keep the old ``n_workers`` shape and
        reject every post-re-shard ``observe``.
        """
        keep = [int(w) for w in survivors]
        if any(w < 0 or w >= self.n_workers for w in keep):
            raise ValueError(
                f"survivor indices {keep} out of range for {self.n_workers} workers"
            )
        if len(set(keep)) != len(keep):
            raise ValueError(f"duplicate survivor indices: {keep}")
        self.n_workers = len(keep)
        self._ewma = self._ewma[keep].copy()
        self._flagged = np.zeros(self.n_workers, np.int64)
        self._steps = 0  # restart warmup: no verdicts until re-measured

    def observe(self, step_times: Sequence[float]) -> Dict[int, Mitigation]:
        """Feed per-worker durations for one step; returns worker -> action."""
        t = np.asarray(step_times, float)
        if t.shape != (self.n_workers,):
            raise ValueError(f"expected {self.n_workers} durations, got {t.shape}")
        self._steps += 1
        if not self._primed:
            self._ewma[:] = t
            self._primed = True
        else:
            self._ewma = self.alpha * t + (1 - self.alpha) * self._ewma

        verdict: Dict[int, Mitigation] = {}
        if self._steps <= self.warmup:
            return verdict
        med = float(np.median(self._ewma))
        slow = self._ewma > self.threshold * max(med, 1e-9)
        self._flagged = np.where(slow, self._flagged + 1, 0)
        for w in np.nonzero(slow)[0]:
            if self._flagged[w] >= self.patience:
                verdict[int(w)] = Mitigation.EXCLUDE
            else:
                verdict[int(w)] = Mitigation.REDISPATCH
        now = self.clock()
        for w, action in verdict.items():
            self.flag_log.append((now, w, action.value))
        return verdict

    @property
    def ewma(self) -> np.ndarray:
        return self._ewma.copy()
