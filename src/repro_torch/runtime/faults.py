"""Deterministic fault injection for the elastic serve fabric (the port's
own copy of ``repro/runtime/faults.py``).

The serve fabric's robustness claims are only testable if failures are
*reproducible*: the same seed and spec list must produce the same crashes at
the same launches on every run, so a faulted serve trace can be compared
byte-for-byte against a fault-free one.  Everything here is therefore
**step-indexed** — faults key off a replica's own launch counter (and the
request ids it carries), never off wall clock, and the optional randomized
mode derives an independent ``numpy`` generator from ``(seed, replica,
step)`` so decisions do not depend on call order.

Fault kinds (the hook raises, or returns a synthetic stall duration):

* ``crash``  — the replica dies before the launch (``ReplicaCrash``); its
  in-flight requests must be re-admitted by the supervisor.  ``shrink=1``
  marks the crash as a device loss, telling the supervisor to rebuild the
  rejoining replica through the elastic re-shard path.
* ``launch`` — a transient launch failure (``TransientLaunchError``) before
  any state is mutated; the supervisor retries with bounded backoff.
* ``stall``  — the launch "runs" ``secs`` seconds too long.  The duration is
  synthetic (returned, not slept) so tests stay fast and deterministic; the
  supervisor adds it to the reported step time (feeding the straggler
  detector) and converts stalls past the launch timeout into transient
  failures *before* the launch executes.
* ``poison`` — a specific request id fails admission every time it is tried
  (``TransientLaunchError`` carrying the rid); the supervisor's per-request
  retry budget must reject it with an error result instead of crash-looping
  the replica.

Process-level kinds (cross-process fabric; never raised through ``check`` —
they act beneath the replica, at the worker/transport layer):

* ``kill``     — hard SIGKILL of the worker process before the indexed
  launch.  No exception crosses the channel: the supervisor may only learn
  of the death through missed heartbeat deadlines.
* ``hang``     — heartbeats stop but the process stays alive (a wedged
  worker); the supervisor must declare it dead and reap it.
* ``slowpipe`` — message delivery from the worker is delayed ``secs``
  seconds (congested control link); stale messages arriving after the
  worker was declared dead must be discarded by incarnation tag.

Spec grammar (CLI-friendly): ``kind@key=val[:key=val...]`` joined by commas,
e.g. ``crash@step=7``, ``launch@step=3:replica=1:times=2``,
``stall@step=2:secs=9:times=4``, ``poison@rid=0``, ``crash@step=5:shrink=1``,
``kill@step=7``, ``hang@step=3:replica=1``, ``slowpipe@secs=2:replica=0``.
``step`` is the replica-local launch index (first launch = step 1); stall
specs may omit it to stall every launch while armed (e.g.
``stall@secs=9:times=4:replica=1`` — a persistently slow replica).

Cross-process, a wildcard (``replica=None``) ``kill``/``hang`` spec is
*reserved* by the supervisor at spawn time for the first worker that claims
it — ``times`` is charged globally at reservation, so ``kill@step=7`` kills
exactly one worker fleet-wide and its replacement is not re-killed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ReplicaFault(Exception):
    """Base class for injected (and real) serve-fabric failures."""


class ReplicaCrash(ReplicaFault):
    """The replica process is gone; its in-flight work must be re-admitted."""

    def __init__(self, msg: str = "replica crash", *, shrink: bool = False):
        super().__init__(msg)
        self.shrink = shrink


class TransientLaunchError(ReplicaFault):
    """A launch failed before mutating state; safe to retry.

    ``rid`` attributes the failure to one request (poisoned prompt) so the
    supervisor can charge that request's retry budget instead of the replica.
    """

    def __init__(self, msg: str = "transient launch failure", *, rid: Optional[int] = None):
        super().__init__(msg)
        self.rid = rid


class RequestRejected(ReplicaFault):
    """A request can never be served (e.g. prompt exceeds the slot budget)."""

    def __init__(self, msg: str, *, rid: int):
        super().__init__(msg)
        self.rid = rid


_KINDS = ("crash", "launch", "stall", "poison", "kill", "hang", "slowpipe")

# Kinds handled at the worker/transport layer; FaultInjector.check ignores
# them so a full --inject string can be shipped verbatim to worker processes.
PROCESS_KINDS = ("kill", "hang", "slowpipe")


@dataclasses.dataclass
class FaultSpec:
    kind: str
    step: Optional[int] = None      # replica-local launch index (1-based)
    replica: Optional[int] = None   # None = any replica
    rid: Optional[int] = None       # poison target
    times: int = 1                  # firings before the spec disarms (<=0 = forever)
    secs: float = 0.0               # stall duration (synthetic seconds)
    shrink: bool = False            # crash models a device loss -> re-shard

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (choose from {_KINDS})")
        if self.kind == "poison" and self.rid is None:
            raise ValueError("poison faults need rid=<request id>")
        if self.kind in ("crash", "launch", "kill", "hang") and self.step is None:
            raise ValueError(f"{self.kind} faults need step=<launch index>")
        if self.kind == "slowpipe" and self.secs <= 0:
            raise ValueError("slowpipe faults need secs=<delivery delay>")


def parse_faults(text: str) -> List[FaultSpec]:
    """Parse the CLI spec list; empty/whitespace input yields no faults."""
    specs: List[FaultSpec] = []
    for part in (p.strip() for p in text.split(",") if p.strip()):
        kind, _, rest = part.partition("@")
        kw: Dict[str, object] = {}
        for field in (f for f in rest.split(":") if f):
            key, _, val = field.partition("=")
            if key in ("step", "replica", "rid", "times"):
                kw[key] = int(val)
            elif key == "secs":
                kw[key] = float(val)
            elif key == "shrink":
                kw[key] = bool(int(val))
            else:
                raise ValueError(f"unknown fault field {key!r} in {part!r}")
        if kind in ("poison", "slowpipe"):
            kw.setdefault("times", 0)  # poison / slowpipe persist by default
        specs.append(FaultSpec(kind=kind, **kw))
    return specs


def split_process_specs(
    specs: Sequence[FaultSpec],
) -> Tuple[List[FaultSpec], List[FaultSpec], List[FaultSpec]]:
    """Partition specs into (kill/hang, slowpipe, in-replica) groups.

    The first two groups are consumed by the cross-process supervisor (spec
    reservation at spawn; pipe delay gates); the rest are replica-level and
    travel to each worker's own :class:`FaultInjector`.
    """
    proc = [s for s in specs if s.kind in ("kill", "hang")]
    slow = [s for s in specs if s.kind == "slowpipe"]
    rest = [s for s in specs if s.kind not in PROCESS_KINDS]
    return proc, slow, rest


class FaultInjector:
    """The injectable serve-step hook: deterministic, seeded, step-indexed.

    ``check(replica, step, phase, rids)`` is called by :class:`ServeReplica`
    immediately before a launch (``phase="launch"``) and before each
    admission prefill (``phase="admit"``, with the candidate ``rids``).  It
    raises the matching fault exception, or returns the synthetic stall
    seconds to charge this launch (0.0 = healthy).

    With ``seed`` set, randomized faults are layered on top of the explicit
    specs: each (replica, step) pair draws crash/transient verdicts from its
    own ``default_rng((seed, replica, step))`` stream, so two injectors with
    the same seed agree everywhere regardless of scheduling order.
    """

    def __init__(
        self,
        specs: Sequence[FaultSpec] = (),
        *,
        seed: Optional[int] = None,
        p_crash: float = 0.0,
        p_transient: float = 0.0,
    ):
        self.specs = [dataclasses.replace(s) for s in specs]
        self._fired = [0] * len(self.specs)
        self.seed = seed
        self.p_crash = p_crash
        self.p_transient = p_transient
        self.log: List[Tuple[int, int, str]] = []  # (replica, step, kind)

    # ------------------------------------------------------------------
    def _armed(self, i: int) -> bool:
        s = self.specs[i]
        return s.times <= 0 or self._fired[i] < s.times

    def _matches(self, s: FaultSpec, replica: int, step: int, phase: str, rids) -> bool:
        if s.kind in PROCESS_KINDS:
            return False  # handled at the worker/transport layer, not in-replica
        if s.replica is not None and s.replica != replica:
            return False
        if s.kind == "poison":
            return phase == "admit" and s.rid in rids
        if s.kind == "stall" and s.step is None:
            return phase == "launch"  # wildcard: every launch while armed
        return phase == "launch" and s.step == step

    def check(
        self, replica: int, step: int, phase: str = "launch", rids: Sequence[int] = ()
    ) -> float:
        stall = 0.0
        for i, s in enumerate(self.specs):
            if not self._armed(i) or not self._matches(s, replica, step, phase, rids):
                continue
            self._fired[i] += 1
            self.log.append((replica, step, s.kind))
            if s.kind == "crash":
                raise ReplicaCrash(
                    f"injected crash (replica {replica}, step {step})", shrink=s.shrink
                )
            if s.kind == "launch":
                raise TransientLaunchError(
                    f"injected transient launch failure (replica {replica}, step {step})"
                )
            if s.kind == "poison":
                raise TransientLaunchError(
                    f"injected poisoned admission (rid {s.rid})", rid=s.rid
                )
            stall = max(stall, s.secs)
        if self.seed is not None and phase == "launch":
            rng = np.random.default_rng([self.seed, replica, step])
            draw = rng.random(2)
            if draw[0] < self.p_crash:
                self.log.append((replica, step, "crash"))
                raise ReplicaCrash(f"seeded crash (replica {replica}, step {step})")
            if draw[1] < self.p_transient:
                self.log.append((replica, step, "launch"))
                raise TransientLaunchError(
                    f"seeded transient failure (replica {replica}, step {step})"
                )
        return stall
