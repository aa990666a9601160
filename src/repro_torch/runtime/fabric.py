"""Elastic serve fabric: N data-parallel serve replicas behind one shared
admission queue, supervised for crashes, transient launch failures, stalls,
and poisoned prompts (the port's copy of the in-process half of
``repro/runtime/fabric.py``; the cross-process fabric is not ported yet).

This is the cluster-granularity analogue of the paper's *autonomous,
peer-to-peer, temporally loosely-coupled* control plane: each replica is an
autonomous continuous-batching loop (``launch.serve.ServeReplica``) advancing
on its own schedule; the supervisor never blocks a healthy replica on a sick
one, and the only shared state is the admission queue plus a periodic
checkpoint snapshot.  The supervisor imports neither torch nor the model
stack: replicas are built through an injected factory, so the policy layer
(retry, backoff, re-admission, degradation) is testable without devices.

Robustness contract (proven by ``tests/test_torch_fabric.py``):

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
  to the factory (the port's factory has no elastic re-shard path yet).
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
