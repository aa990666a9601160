"""Elastic serve fabric: N data-parallel serve replicas behind one shared
admission queue, supervised for crashes, transient launch failures, stalls,
and poisoned prompts (the port's copy of ``repro/runtime/fabric.py``):
:class:`ServeFabric` supervises replicas in its own process,
:class:`CrossProcessFabric` supervises worker processes
(:mod:`repro_torch.runtime.worker`) through messages
(:mod:`repro_torch.runtime.transport`) and heartbeats alone.

This is the cluster-granularity analogue of the paper's *autonomous,
peer-to-peer, temporally loosely-coupled* control plane: each replica is an
autonomous continuous-batching loop (``launch.serve.ServeReplica``) advancing
on its own schedule; the supervisor never blocks a healthy replica on a sick
one, and the only shared state is the admission queue plus a periodic
checkpoint snapshot.  The supervisor imports neither torch nor the model
stack: replicas are built through an injected factory, so the policy layer
(retry, backoff, re-admission, degradation) is testable without devices.

Robustness contract of :class:`ServeFabric` (proven by ``tests/test_torch_fabric.py``;
:class:`CrossProcessFabric`'s by ``tests/test_torch_xproc.py``):

* **Exactly-once results.**  Tokens are buffered inside a replica and only
  *published* when a request completes; on replica death the partial buffer
  is discarded and the request re-admitted (dedup by request id), so no
  token is ever emitted twice and — greedy decode being deterministic — the
  re-run produces byte-identical output.
* **Retry / timeout / backoff.**  A transient launch failure backs the
  replica off for ``backoff_base * 2^(attempt-1)`` scheduler rounds (capped);
  ``max_launch_retries`` consecutive failures escalate to a crash.  A launch
  whose injected stall meets ``launch_timeout`` is converted to a transient
  failure *before* it executes (state never half-mutated).  A request whose
  admission keeps failing (poisoned prompt) is rejected with an error result
  once ``request_retry_budget`` is exhausted, instead of crash-looping the
  replica.
* **Elastic recovery.**  On crash, in-flight requests return to the front of
  the queue; the replica rejoins after ``rejoin_after`` rounds by re-warming
  — params restored from the latest ``CheckpointManager`` snapshot (which
  also records the admission ledger) and lost cache state rebuilt by
  replaying admission prefill.  A crash flagged ``shrink`` passes the flag
  to the factory, which rebuilds on the survivors' mesh
  (``launch.serve.make_replica_factory``'s ``shrink_to``).  Replicas on a
  mesh hold their rank's share of the weights, so the snapshot gathers
  them (``CheckpointManager.save(..., mesh=)``, the mesh of the replica
  built last).
* **Graceful degradation.**  Per-replica step times (wall clock plus any
  injected synthetic stall) feed a ``StragglerDetector``; a flagged replica
  first descends the speculation ladder (tree → chain → width 1 — the
  control plane de-configuring itself) with a warmup restart per step, and
  only when flagged again at the bottom of the ladder is it EXCLUDEd from
  the fabric.  ``synthetic_step_times`` pins the healthy baseline to 1.0 s
  so tests and benchmarks are deterministic (no wall clock in any decision
  that affects tokens).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from repro_torch.core.programs import program_slots
from repro_torch.runtime.faults import (
    ReplicaCrash,
    RequestRejected,
    TransientLaunchError,
)
from repro_torch.runtime.straggler import Mitigation, StragglerDetector


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Any  # 1-D int32 array of prompt token ids
    gen: int     # tokens to generate after the prefill token
    deadline: Optional[float] = None  # absolute fabric-clock time; None = no deadline
    # request program spec (core.programs.compile_program input): constrained
    # decoding + fork/join control flow.  A JSON dict so it rides the wire
    # and survives requeue — crash recovery re-runs the program from scratch
    # and determinism makes the re-run byte-identical.
    program: Optional[dict] = None


@dataclasses.dataclass
class Result:
    rid: int
    tokens: List[int]           # prefill token + generated tokens (empty on error)
    replica: int = -1           # replica that completed (or rejected) the request
    error: Optional[str] = None
    retries: int = 0            # admission retries this request consumed
    branches: Optional[List[List[int]]] = None  # per-branch streams (join="all")


# make_replica(replica_id, degrade_level, params_or_None, shrunk) -> replica.
# ``params`` is the checkpoint-restored tree on a re-warm rebuild (None on the
# initial build); ``shrunk`` asks the factory to rebuild through the elastic
# re-shard path because the crash modeled a device loss.
ReplicaFactory = Callable[[int, int, Optional[Any], bool], Any]


@dataclasses.dataclass
class FabricConfig:
    n_replicas: int = 1
    max_launch_retries: int = 3     # consecutive transient failures -> crash
    request_retry_budget: int = 2   # failed admissions before an error result
    backoff_base: int = 1           # cooldown rounds = base * 2^(attempt-1)
    backoff_cap: int = 8
    launch_timeout: Optional[float] = None  # seconds; stalls past it fail fast
    rejoin_after: int = 1           # rounds a crashed replica stays down
    max_rejoins: int = 8            # crashes beyond this retire the replica
    checkpoint_every: int = 0       # rounds between snapshots; 0 = off
    max_degrade_level: int = 0      # depth of the speculation ladder
    synthetic_step_times: bool = False  # deterministic detector input (tests)
    max_rounds: int = 100_000       # hard guard against supervision livelock


class ServeFabric:
    """Supervisor: one shared queue, N replicas, exactly-once results."""

    def __init__(
        self,
        make_replica: ReplicaFactory,
        requests: List[Request],
        cfg: FabricConfig,
        *,
        ckpt: Optional[Any] = None,  # a repro_torch.checkpoint.CheckpointManager
        restore_params: Optional[Callable[[Any], Any]] = None,
        params: Optional[Any] = None,
        detector: Optional[StragglerDetector] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if len({r.rid for r in requests}) != len(requests):
            raise ValueError("request ids must be unique")
        self.make_replica = make_replica
        self.cfg = cfg
        self.queue: Deque[Request] = deque(requests)
        self.by_rid = {r.rid: r for r in requests}
        self.results: Dict[int, Result] = {}
        self.ckpt = ckpt
        self.restore_params = restore_params
        self.params = params
        self.detector = detector
        # every timing-sensitive policy read goes through this injected clock
        # (monotonic in production, manual in tests) — never time.time()
        self.clock = clock
        self._det_ids: List[int] = []
        n = cfg.n_replicas
        self.replicas: List[Optional[Any]] = [None] * n
        self.level = [0] * n
        self.cooldown = [0] * n
        self.attempts = [0] * n          # consecutive transient launch failures
        self.dead = [False] * n
        self.retired = [False] * n
        self.shrunk = [False] * n
        self.mesh = None  # the mesh of the replica built last (its snapshots gather its shares)
        self.crash_count = [0] * n
        self.request_retries: Dict[int, int] = {}
        self.rewarm_set: set = set()     # rids whose state must be replayed
        self.round = 0
        self.stats: Dict[str, Any] = {
            "crashes": 0, "rejoins": 0, "rewarm_prefills": 0, "restores": 0,
            "transient_failures": 0, "timeouts": 0, "backoff_rounds": 0,
            "request_retries": 0, "poisoned": 0, "rejected": 0,
            "duplicates": 0, "dropped": 0, "excluded": 0, "retired": 0,
            "degradations": [], "checkpoints": 0,
            # aggregated replica counters (absorbed on retirement + at exit)
            "launches": 0, "prefills": 0, "accepted": 0, "drafted": 0,
            "prefill_ms": 0.0, "agreements": [],
            # paged KV plane counters (zero when replicas are unpaged)
            "paged_admissions": 0, "pages_shared": 0, "admit_copy_rows": 0,
            # request-program counters (zero when no request carries one)
            "prog_tokens": 0, "prog_states_visited": 0,
            "prog_mask_frac_sum": 0.0, "prog_mask_cnt": 0,
            "prog_masked_emissions": 0, "forks_started": 0,
            "forks_live_max": 0, "fork_kv_rows_copied": 0,
        }

    # ------------------------------------------------------------------
    # replica lifecycle
    # ------------------------------------------------------------------
    def _build(self, w: int, *, initial: bool = False) -> Any:
        params = None
        if (
            not initial
            and self.restore_params is not None
            and self.ckpt is not None
            and self.ckpt.latest_step() is not None
        ):
            params = self.restore_params(self.ckpt)
            self.stats["restores"] += 1
        rep = self.make_replica(w, self.level[w], params, self.shrunk[w])
        self.shrunk[w] = False
        self.mesh = getattr(rep, "mesh", None)
        return rep

    def _absorb(self, rep: Any) -> None:
        """Fold a discarded (or finished) replica's counters into the stats."""
        if rep is None:
            return
        self.stats["launches"] += getattr(rep, "launches", 0)
        self.stats["prefills"] += getattr(rep, "prefills", 0)
        self.stats["accepted"] += getattr(rep, "accepted_total", 0)
        self.stats["drafted"] += getattr(rep, "drafted_total", 0)
        self.stats["prefill_ms"] += getattr(rep, "prefill_ms", 0.0)
        self.stats["agreements"].extend(getattr(rep, "agreements", []))
        self.stats["paged_admissions"] += getattr(rep, "admissions_paged", 0)
        self.stats["pages_shared"] += getattr(rep, "pages_shared_total", 0)
        self.stats["admit_copy_rows"] += getattr(rep, "admit_copy_rows", 0)
        self.stats["prog_tokens"] += getattr(rep, "prog_tokens", 0)
        self.stats["prog_states_visited"] += len(getattr(rep, "prog_states_seen", ()))
        self.stats["prog_mask_frac_sum"] += getattr(rep, "prog_mask_frac_sum", 0.0)
        self.stats["prog_mask_cnt"] += getattr(rep, "prog_mask_cnt", 0)
        self.stats["prog_masked_emissions"] += getattr(rep, "prog_masked_emissions", 0)
        self.stats["forks_started"] += getattr(rep, "forks_started", 0)
        self.stats["forks_live_max"] = max(
            self.stats["forks_live_max"], getattr(rep, "forks_live_max", 0)
        )
        self.stats["fork_kv_rows_copied"] += getattr(rep, "fork_kv_rows_copied", 0)

    def _requeue_in_flight(self, rep: Any) -> None:
        """Return a dying replica's in-flight requests to the queue front
        (original admission order preserved), discarding partial buffers."""
        if rep is None:
            return
        for req in reversed(rep.in_flight()):
            if req.rid not in self.results:
                self.rewarm_set.add(req.rid)
                self.queue.appendleft(req)

    def _on_crash(self, w: int, err: ReplicaCrash) -> None:
        self.stats["crashes"] += 1
        self.crash_count[w] += 1
        if getattr(err, "shrink", False):
            self.shrunk[w] = True
        self._absorb(self.replicas[w])
        self._requeue_in_flight(self.replicas[w])
        self.replicas[w] = None
        self.dead[w] = True
        self.attempts[w] = 0
        if self.crash_count[w] > self.cfg.max_rejoins:
            self.retired[w] = True
            self.stats["retired"] += 1
        else:
            self.cooldown[w] = self.cfg.rejoin_after
        self._sync_detector()

    def _on_transient(self, w: int, err: TransientLaunchError) -> None:
        self.stats["transient_failures"] += 1
        if "timeout" in str(err):
            self.stats["timeouts"] += 1
        self.attempts[w] += 1
        if self.attempts[w] > self.cfg.max_launch_retries:
            self._on_crash(
                w,
                ReplicaCrash(
                    f"replica {w}: {self.attempts[w] - 1} consecutive "
                    "transient launch failures"
                ),
            )
            return
        self.cooldown[w] = min(
            self.cfg.backoff_cap, self.cfg.backoff_base * (2 ** (self.attempts[w] - 1))
        )
        self.stats["backoff_rounds"] += self.cooldown[w]

    def _rejoin(self, w: int) -> None:
        self.replicas[w] = self._build(w)
        self.dead[w] = False
        self.stats["rejoins"] += 1
        self._sync_detector()

    def _degrade(self, w: int) -> None:
        """Drop one speculation level (tree -> chain -> width 1) and re-warm."""
        self.stats["degradations"].append((w, self.level[w], self.level[w] + 1))
        self.level[w] += 1
        self._absorb(self.replicas[w])
        self._requeue_in_flight(self.replicas[w])
        self.replicas[w] = None
        self.replicas[w] = self._build(w)
        # restart detector warmup so the degraded replica is re-measured fresh
        if self.detector is not None:
            self.detector.rebase(range(self.detector.n_workers))

    def _exclude(self, w: int) -> None:
        self.stats["excluded"] += 1
        self._absorb(self.replicas[w])
        self._requeue_in_flight(self.replicas[w])
        self.replicas[w] = None
        self.dead[w] = True
        self.retired[w] = True
        self._sync_detector()

    def _ensure_capacity(self) -> None:
        """Never deadlock: if work remains but every replica is retired,
        resurrect the lowest id at the bottom of the degradation ladder."""
        if not all(self.retired):
            return
        w = 0
        self.retired[w] = False
        self.dead[w] = True
        self.level[w] = self.cfg.max_degrade_level
        self.crash_count[w] = 0
        self.cooldown[w] = 0

    # ------------------------------------------------------------------
    # straggler detection
    # ------------------------------------------------------------------
    def _live_ids(self) -> List[int]:
        return [
            w for w in range(self.cfg.n_replicas)
            if not self.retired[w] and not self.dead[w]
        ]

    def _sync_detector(self) -> None:
        if self.detector is None:
            return
        ids = self._live_ids()
        if ids == self._det_ids:
            return
        if set(ids) <= set(self._det_ids) and self._det_ids:
            # membership shrank: reindex survivors, keep their EWMA history
            self.detector.rebase([self._det_ids.index(w) for w in ids])
        else:
            # grew (rejoin): fresh detector, same policy knobs
            self.detector = StragglerDetector(
                n_workers=max(len(ids), 1),
                alpha=self.detector.alpha,
                threshold=self.detector.threshold,
                patience=self.detector.patience,
                warmup=self.detector.warmup,
                clock=self.detector.clock,
            )
        self._det_ids = ids

    def _feed_detector(self, times: Dict[int, float]) -> None:
        if self.detector is None or not times:
            return
        self._sync_detector()
        ids = self._det_ids
        if not ids:
            return
        present = [times[w] for w in ids if w in times]
        if not present:
            return
        fill = sorted(present)[len(present) // 2]  # neutral for idle replicas
        vec = [times.get(w, fill) for w in ids]
        verdicts = self.detector.observe(vec)
        for idx, action in verdicts.items():
            w = ids[idx]
            if self.level[w] < self.cfg.max_degrade_level:
                # ladder first: both REDISPATCH and EXCLUDE drop speculation
                # width before the fabric gives up on the replica
                self._degrade(w)
            elif action is Mitigation.EXCLUDE:
                self._exclude(w)

    # ------------------------------------------------------------------
    # admission / results
    # ------------------------------------------------------------------
    def _publish(self, res: Result) -> None:
        if res.rid in self.results:
            self.stats["duplicates"] += 1
            return
        res.retries = self.request_retries.get(res.rid, 0)
        self.results[res.rid] = res
        self.rewarm_set.discard(res.rid)

    def _admit_from_queue(self, w: int, rep: Any) -> None:
        while self.queue and rep.free_slots():
            req = self.queue[0]
            if req.rid in self.results:
                self.queue.popleft()  # dedup: already answered elsewhere
                continue
            # fork programs need K slots at once; wait for the pool to drain
            # rather than hit the replica's free-slot guard (a fork wider
            # than the whole pool passes through: admit rejects it for good)
            free = rep.free_slots()
            n_free = free if isinstance(free, int) else len(free)
            needed = program_slots(getattr(req, "program", None))
            if n_free < needed <= getattr(rep, "B", needed):
                break
            try:
                rep.admit(req)
            except RequestRejected as err:
                self.queue.popleft()
                self.stats["rejected"] += 1
                self._publish(Result(rid=req.rid, tokens=[], replica=w, error=str(err)))
                continue
            except TransientLaunchError as err:
                rid = err.rid if err.rid is not None else req.rid
                count = self.request_retries.get(rid, 0) + 1
                self.request_retries[rid] = count
                self.stats["request_retries"] += 1
                if count > self.cfg.request_retry_budget:
                    self.queue.popleft()
                    self.stats["poisoned"] += 1
                    self._publish(Result(
                        rid=rid, tokens=[], replica=w,
                        error=f"admission failed {count} times "
                              f"(budget {self.cfg.request_retry_budget}): {err}",
                    ))
                else:
                    self.queue.rotate(-1)  # try a different prompt first
                    break
                continue
            self.queue.popleft()
            if req.rid in self.rewarm_set:
                self.stats["rewarm_prefills"] += 1
                self.rewarm_set.discard(req.rid)

    def _maybe_checkpoint(self) -> None:
        if (
            self.ckpt is None
            or self.cfg.checkpoint_every <= 0
            or self.round % self.cfg.checkpoint_every
        ):
            return
        ledger = {
            str(w): self.replicas[w].snapshot_meta()
            for w in self._live_ids()
            if self.replicas[w] is not None
        }
        self.ckpt.save(
            self.round,
            self.params if self.params is not None else {},
            {},
            extra={"round": self.round, "ledger": ledger},
            **({"mesh": self.mesh} if self.mesh is not None else {}),
        )
        self.stats["checkpoints"] += 1

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def _work_remains(self) -> bool:
        if any(req.rid not in self.results for req in self.queue):
            return True
        return any(
            self.replicas[w] is not None and self.replicas[w].has_work()
            for w in range(self.cfg.n_replicas)
            if not self.dead[w] and not self.retired[w]
        )

    def run(self) -> Dict[int, Result]:
        n = self.cfg.n_replicas
        for w in range(n):
            self.replicas[w] = self.make_replica(w, 0, None, False)
            self.mesh = getattr(self.replicas[w], "mesh", None)
        self._sync_detector()
        while self._work_remains():
            self.round += 1
            if self.round > self.cfg.max_rounds:
                raise RuntimeError(
                    f"serve fabric made no progress in {self.cfg.max_rounds} rounds"
                )
            self._ensure_capacity()
            times: Dict[int, float] = {}
            for w in range(n):
                if self.retired[w]:
                    continue
                if self.cooldown[w] > 0:
                    self.cooldown[w] -= 1
                    continue
                if self.dead[w]:
                    self._rejoin(w)
                rep = self.replicas[w]
                self._admit_from_queue(w, rep)
                if not rep.has_work():
                    continue
                t0 = self.clock()
                try:
                    done = rep.step()
                except TransientLaunchError as err:
                    self._on_transient(w, err)
                    continue
                except ReplicaCrash as err:
                    # no reference to the dead replica outlives the crash:
                    # its cache and graphs are freed before it is rebuilt
                    rep = None
                    self._on_crash(w, err)
                    continue
                self.attempts[w] = 0
                base = 1.0 if self.cfg.synthetic_step_times else self.clock() - t0
                times[w] = base + getattr(rep, "last_stall", 0.0)
                for res in done:
                    res.replica = w
                    self._publish(res)
            rep = None  # a degraded or excluded replica is freed when dropped
            self._feed_detector(times)
            self._maybe_checkpoint()
        for w in range(n):
            self._absorb(self.replicas[w])
            self.replicas[w] = None
        self.stats["dropped"] = sum(
            1 for rid in self.by_rid if rid not in self.results
        )
        return self.results


# ---------------------------------------------------------------------------
# cross-process fabric: heartbeat-supervised OS worker processes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class XFabricConfig:
    """Policy knobs for :class:`CrossProcessFabric`.

    All durations are seconds on the fabric's injected clock, so the same
    config drives real ``multiprocessing`` workers (monotonic clock) and
    deterministic loopback tests (manual clock, one ``poll_every`` tick per
    scheduling round).
    """

    workers: int = 1
    slots_per_worker: int = 1
    heartbeat_every: float = 0.25      # worker emission period AND deadline unit
    heartbeat_miss_limit: int = 4      # consecutive missed deadlines -> dead
    spawn_grace: float = 5.0           # liveness holiday while a worker boots
    poll_every: Optional[float] = None  # supervisor round period; None = heartbeat_every
    queue_limit: int = 0               # admission high-water mark; 0 = unbounded
    request_retry_budget: int = 2      # failed admissions before an error result
    max_spawns: int = 4                # deaths per worker slot before retirement
    checkpoint_every: int = 0          # supervisor rounds between snapshots; 0 = off
    max_rounds: int = 200_000          # hard guard against supervision livelock

    def poll(self) -> float:
        return self.heartbeat_every if self.poll_every is None else self.poll_every


class CrossProcessFabric:
    """Supervisor for worker *processes*: liveness by heartbeat, state by disk.

    The in-process :class:`ServeFabric` observes failures as Python
    exceptions.  Here that coupling is gone: workers are autonomous loops
    behind a message channel (``runtime.transport``), and the only failure
    signal the supervisor trusts is **silence** — a worker that misses
    ``heartbeat_miss_limit`` consecutive heartbeat deadlines (SIGKILL'd,
    hung, or wedged behind a slow pipe) is declared dead, reaped, its
    in-flight rids re-enqueued at the queue front, and a replacement spawned
    that re-warms from the on-disk checkpoint directory — no shared Python
    state of any kind.  Messages from a dead incarnation are discarded by
    tag, so a zombie's late ``done`` can never double-publish a stream.

    Admission adds the latency contract the in-process fabric lacked:

    * **Deadlines** — a request past its deadline while still queued is
      answered with an error *without ever costing a launch*; one that was
      in flight on a crashed worker and is already expired is not re-run.
    * **Backpressure** — ``submit`` past the ``queue_limit`` high-water mark
      answers immediately with a rejection result (counted, never silently
      dropped) instead of growing the queue without bound.

    Exactly-once carries over from the in-process fabric: results publish
    once per rid, dedup is by rid, and greedy decode determinism makes
    faulted cross-process runs byte-identical to the sequential oracle.
    """

    def __init__(
        self,
        spawn: Callable[[int, int, List[dict]], Any],
        requests: List[Request],
        cfg: XFabricConfig,
        *,
        clock: Optional[Any] = None,
        specs: Any = (),
        ckpt: Optional[Any] = None,  # a repro_torch.checkpoint.CheckpointManager
        params: Optional[Any] = None,
    ):
        from repro_torch.runtime.faults import split_process_specs
        from repro_torch.runtime.transport import MonotonicClock

        if len({r.rid for r in requests}) != len(requests):
            raise ValueError("request ids must be unique")
        self.spawn_fn = spawn
        self.cfg = cfg
        self.clock = clock if clock is not None else MonotonicClock()
        self.ckpt = ckpt
        self.params = params
        proc, slow, _ = split_process_specs(specs)
        # kill/hang reservations: "remaining" charges spec.times globally at
        # spawn so a wildcard kill fires on exactly one worker fleet-wide
        self._proc = [
            {"kind": s.kind, "step": s.step, "replica": s.replica,
             "remaining": s.times if s.times > 0 else -1}
            for s in proc
        ]
        self._slow = list(slow)
        n = cfg.workers
        self.handles: List[Optional[Any]] = [None] * n
        self.next_inc = [0] * n        # incarnation counter per worker slot
        self.cur_inc = [-1] * n
        self.last_hb = [0.0] * n
        self.misses = [0] * n
        self.deaths = [0] * n
        self.retired = [False] * n
        self.free = [0] * n            # supervisor-side slot accounting
        self.assigned: Dict[int, int] = {}          # rid -> worker
        self.order: List[List[int]] = [[] for _ in range(n)]  # admission order
        self.queue: Deque[Request] = deque()
        self.by_rid: Dict[int, Request] = {}
        self.results: Dict[int, Result] = {}
        self.request_retries: Dict[int, int] = {}
        self.round = 0
        self._stats_msgs = 0
        self.stats: Dict[str, Any] = {
            "kills": 0, "heartbeat_misses": 0, "deadline_expired": 0,
            "backpressure_rejects": 0, "spawns": 0, "restores": 0,
            "requeued": 0, "stale_messages": 0, "transient_failures": 0,
            "request_retries": 0, "poisoned": 0, "rejected": 0,
            "duplicates": 0, "dropped": 0, "retired": 0, "checkpoints": 0,
            "admitted": 0,
            # absorbed worker counters (from shutdown stats messages)
            "launches": 0, "prefills": 0, "accepted": 0, "drafted": 0,
            "prog_tokens": 0, "prog_masked_emissions": 0,
            "forks_started": 0, "fork_kv_rows_copied": 0,
        }
        for req in requests:
            self.submit(req)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admit a request to the supervisor queue; False = backpressure."""
        if req.rid in self.by_rid:
            raise ValueError(f"duplicate rid {req.rid}")
        self.by_rid[req.rid] = req
        if self.cfg.queue_limit > 0 and len(self.queue) >= self.cfg.queue_limit:
            self.stats["backpressure_rejects"] += 1
            self._publish(Result(
                rid=req.rid, tokens=[],
                error=f"rejected: admission queue at high-water mark "
                      f"({self.cfg.queue_limit})",
            ))
            return False
        self.queue.append(req)
        return True

    def _publish(self, res: Result) -> None:
        if res.rid in self.results:
            self.stats["duplicates"] += 1
            return
        res.retries = self.request_retries.get(res.rid, 0)
        self.results[res.rid] = res

    def _expired(self, req: Request) -> bool:
        return req.deadline is not None and self.clock.now() > req.deadline

    # ------------------------------------------------------------------
    # worker lifecycle
    # ------------------------------------------------------------------
    def _reserve_proc_faults(self, w: int) -> List[dict]:
        out = []
        for entry in self._proc:
            if entry["replica"] is not None and entry["replica"] != w:
                continue
            if entry["remaining"] == 0:
                continue
            if entry["remaining"] > 0:
                entry["remaining"] -= 1
            out.append({"kind": entry["kind"], "step": entry["step"]})
        return out

    def _spawn(self, w: int) -> None:
        from repro_torch.runtime.transport import SlowPipe

        inc = self.next_inc[w]
        self.next_inc[w] += 1
        handle = self.spawn_fn(w, inc, self._reserve_proc_faults(w))
        for s in self._slow:
            if s.replica in (None, w):
                handle = SlowPipe(handle, self.clock, s.secs, times=s.times)
        self.handles[w] = handle
        self.cur_inc[w] = inc
        # future-dated "heartbeat": a booting worker gets spawn_grace of
        # silence before deadlines start counting (first real message resets)
        self.last_hb[w] = self.clock.now() + self.cfg.spawn_grace
        self.misses[w] = 0
        self.free[w] = self.cfg.slots_per_worker
        self.order[w] = []
        self.stats["spawns"] += 1

    def _declare_dead(self, w: int) -> None:
        """Heartbeat deadline exhausted: reap, re-enqueue, respawn."""
        self.stats["kills"] += 1
        handle = self.handles[w]
        if handle is not None:
            handle.kill()
            handle.close()
        self.handles[w] = None
        self.cur_inc[w] = -1  # every further message from this worker is stale
        pending: List[Request] = []
        for rid in self.order[w]:
            self.assigned.pop(rid, None)
            if rid in self.results:
                continue
            req = self.by_rid[rid]
            if self._expired(req):
                # expired while in flight on the crashed worker: answer now,
                # never re-run a stream nobody is waiting for
                self.stats["deadline_expired"] += 1
                self._publish(Result(
                    rid=rid, tokens=[], replica=w,
                    error=f"deadline expired while in flight on dead worker {w}",
                ))
            else:
                pending.append(req)
        for req in reversed(pending):  # queue front, admission order preserved
            self.queue.appendleft(req)
            self.stats["requeued"] += 1
        self.order[w] = []
        self.deaths[w] += 1
        if self.deaths[w] > self.cfg.max_spawns:
            self.retired[w] = True
            self.stats["retired"] += 1
            if all(self.retired) and not self._done():
                raise RuntimeError(
                    "cross-process fabric out of capacity: every worker slot "
                    f"retired after {sum(self.deaths)} deaths with work remaining"
                )
        else:
            self._spawn(w)

    # ------------------------------------------------------------------
    # message pump + liveness
    # ------------------------------------------------------------------
    def _slots_of(self, rid: int) -> int:
        """Decode slots a dispatched rid holds on its worker (fork width)."""
        req = self.by_rid.get(rid)
        return program_slots(getattr(req, "program", None)) if req is not None else 1

    def _handle_admit_failed(self, w: int, p: dict) -> None:
        rid = int(p["rid"])
        self.assigned.pop(rid, None)
        if rid in self.order[w]:
            self.order[w].remove(rid)
        self.free[w] += self._slots_of(rid)
        if p.get("kind") == "rejected":
            self.stats["rejected"] += 1
            self._publish(Result(rid=rid, tokens=[], replica=w, error=str(p.get("error"))))
            return
        count = self.request_retries.get(rid, 0) + 1
        self.request_retries[rid] = count
        self.stats["request_retries"] += 1
        if count > self.cfg.request_retry_budget:
            self.stats["poisoned"] += 1
            self._publish(Result(
                rid=rid, tokens=[], replica=w,
                error=f"admission failed {count} times "
                      f"(budget {self.cfg.request_retry_budget}): {p.get('error')}",
            ))
        elif rid in self.by_rid:
            self.queue.append(self.by_rid[rid])  # retry later, other prompts first

    def _pump(self) -> None:
        for w in range(self.cfg.workers):
            handle = self.handles[w]
            if handle is None or self.retired[w]:
                continue
            for tag, p in handle.recv():
                if p.get("inc") != self.cur_inc[w]:
                    self.stats["stale_messages"] += 1
                    continue
                # any live message is proof of liveness; deadlines restart
                self.last_hb[w] = self.clock.now()
                self.misses[w] = 0
                if tag == "hello":
                    self.stats["restores"] += int(p.get("restored", 0))
                elif tag == "hb":
                    pass
                elif tag == "done":
                    for rid, tokens in p["results"]:
                        self._publish(Result(rid=int(rid), tokens=list(tokens), replica=w))
                        self.assigned.pop(int(rid), None)
                        if int(rid) in self.order[w]:
                            self.order[w].remove(int(rid))
                        self.free[w] += self._slots_of(int(rid))
                elif tag == "admitted":
                    pass
                elif tag == "admit_failed":
                    self._handle_admit_failed(w, p)
                elif tag == "transient":
                    self.stats["transient_failures"] += 1
                elif tag == "stats":
                    self._stats_msgs += 1
                    self.stats["launches"] += int(p.get("launches", 0))
                    self.stats["prefills"] += int(p.get("prefills", 0))
                    self.stats["accepted"] += int(p.get("accepted", 0))
                    self.stats["drafted"] += int(p.get("drafted", 0))
                    self.stats["prog_tokens"] += int(p.get("prog_tokens", 0))
                    self.stats["prog_masked_emissions"] += int(
                        p.get("prog_masked_emissions", 0))
                    self.stats["forks_started"] += int(p.get("forks_started", 0))
                    self.stats["fork_kv_rows_copied"] += int(
                        p.get("fork_kv_rows_copied", 0))

    def _check_liveness(self) -> None:
        now = self.clock.now()
        for w in range(self.cfg.workers):
            if self.handles[w] is None or self.retired[w]:
                continue
            age = now - self.last_hb[w]
            if age <= 0:
                continue
            missed = int(age // self.cfg.heartbeat_every)
            if missed > self.misses[w]:
                self.stats["heartbeat_misses"] += missed - self.misses[w]
                self.misses[w] = missed
            if self.misses[w] >= self.cfg.heartbeat_miss_limit:
                self._declare_dead(w)

    # ------------------------------------------------------------------
    # dispatch / checkpoint
    # ------------------------------------------------------------------
    def _dispatch(self) -> None:
        for w in range(self.cfg.workers):
            if self.handles[w] is None or self.retired[w]:
                continue
            while self.free[w] > 0 and self.queue:
                req = self.queue[0]
                if req.rid in self.results:
                    self.queue.popleft()
                    continue
                if self._expired(req):
                    self.queue.popleft()
                    self.stats["deadline_expired"] += 1
                    self._publish(Result(
                        rid=req.rid, tokens=[],
                        error="deadline expired while queued (never launched)",
                    ))
                    continue
                needed = program_slots(getattr(req, "program", None))
                if needed > self.cfg.slots_per_worker:
                    self.queue.popleft()
                    self.stats["rejected"] += 1
                    self._publish(Result(
                        rid=req.rid, tokens=[],
                        error=f"program forks {needed} ways but workers have "
                              f"{self.cfg.slots_per_worker} slots",
                    ))
                    continue
                if self.free[w] < needed:
                    break  # fork needs more slots than this worker has free
                self.queue.popleft()
                prompt = req.prompt if req.prompt is not None else []
                self.handles[w].send(("admit", {
                    "rid": int(req.rid),
                    "prompt": [int(t) for t in list(prompt)],
                    "gen": int(req.gen),
                    "program": getattr(req, "program", None),
                }))
                self.assigned[req.rid] = w
                self.order[w].append(req.rid)
                self.free[w] -= needed
                self.stats["admitted"] += 1

    def _maybe_checkpoint(self) -> None:
        if self.ckpt is None or self.cfg.checkpoint_every <= 0:
            return
        # round 1 always snapshots, so the very first replacement worker has
        # a committed step to re-warm from regardless of poll cadence
        if self.round != 1 and self.round % self.cfg.checkpoint_every:
            return
        ledger = {
            str(w): {"rids": list(self.order[w])}
            for w in range(self.cfg.workers)
            if self.handles[w] is not None
        }
        self.ckpt.save(
            self.round,
            self.params if self.params is not None else {},
            {},
            extra={"round": self.round, "ledger": ledger},
        )
        self.stats["checkpoints"] += 1

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def _done(self) -> bool:
        return len(self.results) >= len(self.by_rid)

    def _shutdown(self) -> None:
        waiting = []
        for w in range(self.cfg.workers):
            if self.handles[w] is not None and not self.retired[w]:
                self.handles[w].send(("shutdown", {}))
                waiting.append(w)
        # drain the farewell "stats" messages (bounded: a worker that dies
        # instead of answering must not stall the exit path)
        for _ in range(50):
            if self._stats_msgs >= len(waiting):
                break
            self._pump()
            self.clock.sleep(min(self.cfg.poll(), 0.05))
        for w in range(self.cfg.workers):
            if self.handles[w] is not None:
                self.handles[w].kill()
                self.handles[w].close()
                self.handles[w] = None

    def run(self) -> Dict[int, Result]:
        for w in range(self.cfg.workers):
            self._spawn(w)
        while not self._done():
            self.round += 1
            if self.round > self.cfg.max_rounds:
                self._shutdown()
                raise RuntimeError(
                    f"cross-process fabric made no progress in "
                    f"{self.cfg.max_rounds} rounds"
                )
            self._pump()
            self._check_liveness()
            self._dispatch()
            self._maybe_checkpoint()
            if not self._done():
                self.clock.sleep(self.cfg.poll())
        self._shutdown()
        self.stats["dropped"] = sum(
            1 for rid in self.by_rid if rid not in self.results
        )
        return self.results
