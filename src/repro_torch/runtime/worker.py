"""Autonomous serve worker: the replica side of the cross-process fabric
(the port's counterpart of ``repro/runtime/worker.py``).

A worker owns one :class:`repro_torch.launch.serve.ServeReplica` (or a
:class:`SyntheticReplica` in tests) and talks to the supervisor only
through messages:

    supervisor -> worker:  ("admit", {rid, prompt, gen, program})  |  ("shutdown", {})
    worker -> supervisor:  ("hello", {restored})          # ready, maybe re-warmed
                           ("hb", {step})                 # liveness heartbeat
                           ("done", {results})            # finished token streams
                           ("admitted" | "admit_failed", {rid, ...})
                           ("transient", {error})         # retryable launch failure
                           ("stats", {...})               # final counters on shutdown

Every message carries ``worker`` and ``inc`` (incarnation), so the
supervisor can discard stragglers from a worker it has already declared
dead: exactly-once survives slow pipes and zombie senders.  Only Python
ints, lists and dicts cross the pipe; no tensor does.

The worker is autonomous in the paper's sense: nobody steps it.  Its loop
drains the inbox, emits a heartbeat when one is due, and launches a decode
step whenever it holds work.  Process-level faults act here, beneath the
replica: ``kill`` SIGKILLs the worker's own process (no farewell, no
exception crosses the channel), ``hang`` stops heartbeats while the process
stays alive; the supervisor observes both only as silence.

:func:`worker_main` is the real-process entry point.  The spawned child
imports ``repro_torch`` (and with it torch) to unpickle it; its first act is
to start the heartbeat thread, before the model build, the kernel
libraries' load and the CUDA graph captures, so none of those reads as a
missed deadline.  A replacement (``warm_start``) restores its weights from
the checkpoint directory, the only state it shares with the supervisor.
"""
from __future__ import annotations

import os
import signal
import time
from collections import namedtuple
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from repro_torch.runtime.faults import (
    FaultInjector,
    ReplicaCrash,
    RequestRejected,
    TransientLaunchError,
    parse_faults,
)

# What crosses the pipe: ``program`` carries the request's program spec (a
# JSON dict) and defaults to None, so flat requests construct with three
# positional fields.
WireRequest = namedtuple("WireRequest", "rid prompt gen program")
WireRequest.__new__.__defaults__ = (None,)
WireResult = namedtuple("WireResult", "rid tokens")


class SyntheticReplica:
    """Deterministic model-free replica: request ``rid`` streams ``rid*1000 + i``.

    Mirrors the ``ServeReplica`` surface the worker loop touches (``admit``
    / ``step`` / ``has_work`` / ``free_slots`` and the counters), so
    transport and supervision tests run in milliseconds with byte-checkable
    output."""

    def __init__(self, slots: int = 1, *, replica_id: int = 0, fault_hook=None,
                 launch_timeout: Optional[float] = None):
        self.slots = int(slots)
        self.replica_id = int(replica_id)
        self.fault_hook = fault_hook
        self.launch_timeout = launch_timeout
        self.requests: List[Optional[WireRequest]] = [None] * self.slots
        self.emitted: List[List[int]] = [[] for _ in range(self.slots)]
        self.gen_left = [0] * self.slots
        self.steps = 0
        self.launches = 0
        self.prefills = 0
        self.accepted_total = 0
        self.drafted_total = 0
        self.last_stall = 0.0

    def free_slots(self) -> int:
        return sum(1 for r in self.requests if r is None)

    def has_work(self) -> bool:
        return any(r is not None for r in self.requests)

    def in_flight(self) -> List[WireRequest]:
        return [r for r in self.requests if r is not None]

    def admit(self, req) -> int:
        if self.fault_hook is not None:
            self.fault_hook(self.replica_id, self.steps + 1, phase="admit", rids=(req.rid,))
        free = [i for i, r in enumerate(self.requests) if r is None]
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]
        self.requests[slot] = req
        self.emitted[slot] = [req.rid * 1000]
        self.gen_left[slot] = int(req.gen)
        self.prefills += 1
        return slot

    def step(self) -> List[WireResult]:
        if not self.has_work():
            return []
        self.steps += 1
        rids = tuple(r.rid for r in self.requests if r is not None)
        if self.fault_hook is not None:
            stall = self.fault_hook(self.replica_id, self.steps, phase="launch", rids=rids)
            if stall:
                self.last_stall = float(stall)
                if self.launch_timeout is not None and stall > self.launch_timeout:
                    raise TransientLaunchError(f"synthetic launch stalled {stall:.0f}s > timeout")
        self.launches += 1
        done: List[WireResult] = []
        for slot, req in enumerate(self.requests):
            if req is None:
                continue
            self.emitted[slot].append(req.rid * 1000 + len(self.emitted[slot]))
            self.gen_left[slot] -= 1
            self.accepted_total += 1
            self.drafted_total += 1
            if self.gen_left[slot] <= 0:
                done.append(WireResult(req.rid, list(self.emitted[slot])))
                self.requests[slot] = None
                self.emitted[slot] = []
        return done


class WorkerLoop:
    """Message-driven replica loop shared by loopback and process modes.

    One ``pump()`` drains the inbox, emits a due heartbeat, and runs at
    most one decode launch: in loopback mode the supervisor pumps it once
    a scheduling round, in process mode ``run()`` spins it.  Process faults
    fire *before* the launch they index, so a ``kill@step=7`` worker never
    emits step 7's tokens.  ``extra_stats`` (a callable returning a dict)
    adds to the farewell ``stats`` message, e.g. the process's kernel
    launch counts."""

    def __init__(self, endpoint: Any, replica: Any, *, worker_id: int, incarnation: int,
                 clock: Any, heartbeat_every: float, proc_faults: Sequence[dict] = (),
                 die=None, hb_stop=None, extra_stats: Optional[Callable[[], dict]] = None):
        self.endpoint = endpoint
        self.replica = replica
        self.worker_id = int(worker_id)
        self.incarnation = int(incarnation)
        self.clock = clock
        self.heartbeat_every = float(heartbeat_every)
        self.proc_faults = [dict(f) for f in proc_faults]
        self._die_fn = die
        self._hb_stop = hb_stop
        self._extra_stats = extra_stats
        self._next_hb = clock.now()
        self.hanging = False
        self.killed = False
        self.shutdown = False

    # -- outbound ----------------------------------------------------------
    def _send(self, tag: str, **payload) -> None:
        payload["worker"] = self.worker_id
        payload["inc"] = self.incarnation
        self.endpoint.send((tag, payload))

    def hello(self, restored: int = 0) -> None:
        self._send("hello", restored=int(restored))

    def _stats(self) -> dict:
        r = self.replica
        out = {
            "launches": getattr(r, "launches", 0),
            "prefills": getattr(r, "prefills", 0),
            "accepted": getattr(r, "accepted_total", 0),
            "drafted": getattr(r, "drafted_total", 0),
            "prog_tokens": getattr(r, "prog_tokens", 0),
            "prog_masked_emissions": getattr(r, "prog_masked_emissions", 0),
            "forks_started": getattr(r, "forks_started", 0),
            "fork_kv_rows_copied": getattr(r, "fork_kv_rows_copied", 0),
        }
        if self._extra_stats is not None:
            out.update(self._extra_stats())
        return out

    # -- fault plumbing ----------------------------------------------------
    def _take_proc_fault(self, step: int) -> Optional[str]:
        for f in self.proc_faults:
            if not f.get("fired") and int(f["step"]) == step:
                f["fired"] = True
                return str(f["kind"])
        return None

    def _die(self) -> None:
        self.killed = True
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._die_fn is not None:
            self._die_fn()

    def _hang(self) -> None:
        self.hanging = True
        if self._hb_stop is not None:
            self._hb_stop.set()

    def terminate(self) -> None:
        """Loopback SIGKILL: silence the loop without any farewell message."""
        self.killed = True

    # -- inbound -----------------------------------------------------------
    def _admit(self, p: dict) -> None:
        req = WireRequest(int(p["rid"]), np.asarray(p.get("prompt") or [], dtype=np.int32), int(p["gen"]),
                          p.get("program"))
        try:
            self.replica.admit(req)
        except RequestRejected as e:
            self._send("admit_failed", rid=req.rid, kind="rejected", error=str(e))
            return
        except TransientLaunchError as e:
            self._send("admit_failed", rid=req.rid, kind="transient", error=str(e))
            return
        self._send("admitted", rid=req.rid)

    # -- the loop body -----------------------------------------------------
    def pump(self) -> bool:
        """One scheduling round; returns True if a launch ran."""
        if self.killed or self.shutdown:
            return False
        for tag, p in self.endpoint.drain():
            if tag == "admit":
                if not self.hanging:
                    self._admit(p)
            elif tag == "shutdown":
                self._send("stats", **self._stats())
                self.shutdown = True
                return False
        if self.hanging:
            return False
        if self.clock.now() >= self._next_hb:
            self._send("hb", step=getattr(self.replica, "steps", 0))
            self._next_hb = self.clock.now() + self.heartbeat_every
        if not self.replica.has_work():
            return False
        kind = self._take_proc_fault(self.replica.steps + 1)
        if kind == "kill":
            self._die()
            return False
        if kind == "hang":
            self._hang()
            return False
        try:
            done = self.replica.step()
        except TransientLaunchError as e:
            self._send("transient", error=str(e))
            return True
        except ReplicaCrash:
            # cross-process there is no exception channel to the supervisor:
            # a crash IS process death, observed only as missing heartbeats
            self._die()
            return False
        if done:
            self._send("done", results=[(int(r.rid), [int(t) for t in r.tokens]) for r in done])
        return True

    def run(self, idle_sleep: float = 0.005) -> None:
        """Process mode: spin until shutdown or death.  A hung
        worker stays here, alive but silent, until the supervisor reaps it
        with SIGKILL."""
        while not (self.killed or self.shutdown):
            if self.hanging:
                time.sleep(0.05)
                continue
            if not self.pump():
                time.sleep(idle_sleep)


def make_loopback_spawn(make_replica, clock, *, heartbeat_every: float = 1.0, pumps_per_recv: int = 1):
    """Spawn factory wiring :class:`WorkerLoop` over an in-memory duplex.

    ``make_replica(worker_id, incarnation)`` builds the replica (attach any
    fault hook there); the shared ``clock`` should be the supervisor's, so
    the heartbeat cadence is pinned to logical rounds."""
    from repro_torch.runtime.transport import LoopbackHandle, duplex_pair

    def spawn(worker_id: int, incarnation: int, proc_faults: List[dict]):
        sup_end, wrk_end = duplex_pair()
        loop = WorkerLoop(
            wrk_end,
            make_replica(worker_id, incarnation),
            worker_id=worker_id,
            incarnation=incarnation,
            clock=clock,
            heartbeat_every=heartbeat_every,
            proc_faults=proc_faults,
        )
        loop.hello(0)
        return LoopbackHandle(sup_end, loop, pumps_per_recv=pumps_per_recv)

    return spawn


# ---------------------------------------------------------------------------
# real-process entry point
# ---------------------------------------------------------------------------


class _ConnEndpoint:
    """Pipe endpoint with a send lock shared with the heartbeat thread."""

    def __init__(self, conn, lock):
        self._conn = conn
        self._lock = lock

    def send(self, msg) -> None:
        with self._lock:
            try:
                self._conn.send(msg)
            except (BrokenPipeError, OSError, ValueError):
                pass

    def drain(self) -> List[Any]:
        msgs: List[Any] = []
        while self._conn.poll(0):
            msgs.append(self._conn.recv())
        return msgs


def _build_replica(spec: dict):
    """Build the worker's replica from a picklable spec; returns (replica, restored).

    ``kind="serve"`` builds the port's ``ServeReplica`` on ``spec["device"]``
    (None, the default, means the card; ``"cpu"`` the plain versions of
    every kernel) from the config fields the CLI passes; ``num_layers``
    cuts the depth.  A replacement (``warm_start``) restores its weights
    from the newest committed step in ``ckpt_dir``; otherwise, or when no
    step is committed yet, they are drawn from ``seed`` on the device, the
    same draws as the supervisor's, so the streams are the same either way."""
    faults = spec.get("faults") or ""
    injector = FaultInjector(parse_faults(faults)) if faults else None
    hook = injector.check if injector is not None else None
    kind = spec.get("kind", "synthetic")
    if kind == "synthetic":
        return (
            SyntheticReplica(int(spec.get("slots", 1)), replica_id=int(spec["worker_id"]), fault_hook=hook,
                             launch_timeout=spec.get("launch_timeout")),
            0,
        )

    import dataclasses

    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.plans import TreePlan
    from repro_torch.launch.serve import ServeReplica
    from repro_torch.models.model import Model

    tree = None
    width = max(int(spec.get("spec_tokens", 1)), 1)
    if spec.get("draft_tree"):
        tree = TreePlan.from_branching(list(spec["draft_tree"])).validate()
        width = tree.num_nodes
    cfg = get_smoke_config(spec["arch"]) if spec.get("smoke", True) else get_config(spec["arch"])
    cfg = dataclasses.replace(
        cfg,
        decode_plane=bool(spec.get("decode_plane", cfg.decode_plane)),
        spec_tokens=width,
        paged=bool(spec.get("paged", cfg.paged)),
        page_size=int(spec.get("page_size") or cfg.page_size),
        kv_dtype=str(spec.get("kv_dtype") or cfg.kv_dtype),
        expert_dtype=str(spec.get("expert_dtype") or cfg.expert_dtype),
    )
    if spec.get("num_layers"):
        cfg = dataclasses.replace(cfg, num_layers=int(spec["num_layers"]))
    device = resolve_device(spec.get("device"))
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    params, restored = None, 0
    ckpt_dir = spec.get("ckpt_dir")
    if spec.get("warm_start") and ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, cfg=cfg)
        if mgr.latest_step() is not None:
            try:
                params = mgr.restore(device)[0]
                restored = 1
            except FileNotFoundError:
                pass
    if params is None:
        params = Model(cfg, device=device).init(int(spec.get("seed", 0)))
    replica = ServeReplica(
        cfg,
        int(spec["slots"]),
        int(spec["max_len"]),
        params,
        tree=tree,
        drafter=spec.get("drafter", "ngram"),
        device=device,
        fault_hook=hook,
        launch_timeout=spec.get("launch_timeout"),
        replica_id=int(spec["worker_id"]),
    )
    return replica, restored


def _kernel_launch_counts() -> dict:
    """This process's kernel launch counts, for the farewell ``stats``."""
    from repro_torch.kernels import launch_counts

    return {"kernels": launch_counts()}


def _heartbeat_thread(send, worker_id: int, incarnation: int, every: float, stop):
    while not stop.wait(every):
        send(("hb", {"worker": worker_id, "inc": incarnation, "step": -1}))


def worker_main(conn, spec: dict) -> None:
    """Entry point of a spawned worker process.

    The heartbeat thread starts first, before the replica is built (model,
    kernel libraries, graph captures), so that work can never exceed the
    supervisor's liveness deadline.  ``kill`` faults SIGKILL our own pid
    (indistinguishable from an external kill); ``hang`` stops the heartbeat
    thread and parks the loop.  A replica that cannot be built raises: its
    traceback goes to the inherited stderr and the process dies, which the
    supervisor sees as silence."""
    import threading

    stop_hb = threading.Event()
    lock = threading.Lock()
    worker_id = int(spec["worker_id"])
    incarnation = int(spec["incarnation"])
    endpoint = _ConnEndpoint(conn, lock)
    every = float(spec.get("heartbeat_every", 0.25))
    hb = threading.Thread(target=_heartbeat_thread, args=(endpoint.send, worker_id, incarnation, every, stop_hb),
                          daemon=True)
    hb.start()
    try:
        replica, restored = _build_replica(spec)
        loop = WorkerLoop(
            endpoint,
            replica,
            worker_id=worker_id,
            incarnation=incarnation,
            clock=_Mono(),
            heartbeat_every=every,
            proc_faults=spec.get("proc_faults", ()),
            die=lambda: os.kill(os.getpid(), signal.SIGKILL),
            hb_stop=stop_hb,
            extra_stats=_kernel_launch_counts if spec.get("kind") == "serve" else None,
        )
        try:
            loop.hello(restored)
            loop.run()
        except (EOFError, BrokenPipeError, OSError, KeyboardInterrupt):
            pass  # the supervisor went away; exit quietly
    finally:
        stop_hb.set()


class _Mono:
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)
