"""Pluggable transport for the cross-process serve fabric (the port's own
copy of ``repro/runtime/transport.py``; standard library only).

The in-process ``ServeFabric`` supervises replicas through in-process
exceptions, a coupling the paper's control plane rejects (autonomous peers,
loosely coupled in time, coordinating only through messages).  This module
is the channel layer that severs it: the supervisor sees a worker only as a
handle (``send`` / ``recv`` / ``kill`` / ``close``), and two interchangeable
implementations back it:

* :class:`LoopbackHandle`: the worker's message loop runs in-process and is
  pumped cooperatively on every ``recv``.  With a shared
  :class:`ManualClock` heartbeat supervision is fully deterministic: tests
  advance time explicitly and every liveness verdict lands at an exact
  logical round.
* :class:`ProcessHandle`: a real OS process (``multiprocessing`` spawn
  context, which CUDA requires: a forked child cannot use the parent's
  CUDA context) running :func:`repro_torch.runtime.worker.worker_main`
  over a duplex pipe.  ``kill()`` is a hard SIGKILL; ``recv`` swallows EOF
  and broken-pipe errors, so death is only ever *detected* by the
  supervisor's heartbeat deadlines, never by an exception path.

Clocks are explicit everywhere (no policy code reads ``time.time()``):
:class:`MonotonicClock` for production, :class:`ManualClock` for tests,
where ``sleep`` advances logical time.

The ``slowpipe`` fault lives here too: :class:`SlowPipe` wraps a handle and
delays inbound delivery by a fixed number of seconds (FIFO order kept),
modelling a congested control network: delayed heartbeats can push a
healthy worker past its liveness deadline, and the supervisor must stay
exactly-once anyway (stale-incarnation messages are dropped).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, List, Tuple

Message = Tuple[str, dict]


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------


class MonotonicClock:
    """Wall time for production: monotonic reads, real sleeps."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class ManualClock:
    """Deterministic logical time: ``sleep`` advances, nothing blocks.

    Shared between a supervisor and its loopback workers, it pins every
    heartbeat emission and every liveness deadline to an exact logical
    instant."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._t += seconds

    def advance(self, seconds: float) -> None:
        self._t += seconds


# ---------------------------------------------------------------------------
# in-memory duplex (loopback channel)
# ---------------------------------------------------------------------------


class DuplexEnd:
    """One side of an in-memory bidirectional channel."""

    def __init__(self, inbox: Deque[Message], outbox: Deque[Message]):
        self._inbox = inbox
        self._outbox = outbox

    def send(self, msg: Message) -> None:
        self._outbox.append(msg)

    def drain(self) -> List[Message]:
        out = list(self._inbox)
        self._inbox.clear()
        return out


def duplex_pair() -> Tuple[DuplexEnd, DuplexEnd]:
    a_to_b: Deque[Message] = deque()
    b_to_a: Deque[Message] = deque()
    return DuplexEnd(b_to_a, a_to_b), DuplexEnd(a_to_b, b_to_a)


# ---------------------------------------------------------------------------
# supervisor-side worker handles
# ---------------------------------------------------------------------------


class LoopbackHandle:
    """In-process worker behind the message interface.

    ``recv`` pumps the embedded worker loop before draining its outbox, so
    one supervisor round advances the worker by at most ``pumps_per_recv``
    launches, every interaction going through messages.  ``kill`` silences
    the loop for good (the loopback SIGKILL: no farewell message, no
    exception reaches the supervisor)."""

    def __init__(self, endpoint: DuplexEnd, loop: Any, *, pumps_per_recv: int = 1):
        self._end = endpoint
        self.loop = loop
        self._pumps = max(int(pumps_per_recv), 1)

    def send(self, msg: Message) -> None:
        self._end.send(msg)

    def recv(self) -> List[Message]:
        for _ in range(self._pumps):
            self.loop.pump()
        return self._end.drain()

    def kill(self) -> None:
        self.loop.terminate()

    def close(self) -> None:
        pass


class ProcessHandle:
    """A real OS worker process over a pipe (``multiprocessing`` spawn).

    The pipe is never trusted for liveness: ``recv`` returns whatever is
    readable and treats EOF or a broken pipe as "no messages", so a
    SIGKILLed worker looks exactly like a silent one and the heartbeat
    deadline is the only death detector.  ``kill`` delivers SIGKILL and
    joins for up to 5 s, so the process is reaped (and, on the card, its
    memory on its way back) before a replacement is spawned."""

    def __init__(self, spec: dict):
        import multiprocessing as mp

        from repro_torch.runtime.worker import worker_main

        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=True)
        self.proc = ctx.Process(target=worker_main, args=(child, dict(spec)), daemon=True)
        self.proc.start()
        child.close()

    def send(self, msg: Message) -> None:
        try:
            self.conn.send(msg)
        except (BrokenPipeError, OSError, ValueError):
            pass

    def recv(self) -> List[Message]:
        msgs: List[Message] = []
        try:
            while self.conn.poll(0):
                msgs.append(self.conn.recv())
        except (EOFError, BrokenPipeError, OSError):
            pass
        return msgs

    def kill(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=5.0)

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=5.0)


class SlowPipe:
    """Delay inbound delivery from one worker (the ``slowpipe`` fault).

    Each armed delivery is held ``secs`` seconds past its arrival on the
    fabric clock; FIFO order is kept (a held message blocks everything
    behind it), so the gate models a congested link, not a reordering one.
    ``times`` follows the fault-spec convention: the number of messages
    delayed, ``<= 0`` meaning every message."""

    def __init__(self, handle: Any, clock: Any, secs: float, *, times: int = 0):
        self._handle = handle
        self._clock = clock
        self._secs = float(secs)
        self._remaining = int(times) if times > 0 else -1  # -1 = forever
        self._held: Deque[Tuple[float, Message]] = deque()

    def _armed(self) -> bool:
        return self._remaining != 0

    def send(self, msg: Message) -> None:
        self._handle.send(msg)

    def recv(self) -> List[Message]:
        now = self._clock.now()
        for msg in self._handle.recv():
            if self._held or self._armed():
                delay = self._secs if self._armed() else 0.0
                if self._armed() and self._remaining > 0:
                    self._remaining -= 1
                self._held.append((now + delay, msg))
            else:
                self._held.append((now, msg))
        out: List[Message] = []
        while self._held and self._held[0][0] <= now:
            out.append(self._held.popleft()[1])
        return out

    def kill(self) -> None:
        self._handle.kill()

    def close(self) -> None:
        self._handle.close()

    @property
    def loop(self) -> Any:  # the loopback worker loop behind the delay (tests)
        return getattr(self._handle, "loop", None)


# spawn(worker_id, incarnation, proc_faults) -> handle.  ``proc_faults`` is
# the supervisor's reservation of kill/hang specs for this incarnation
# (a list of {"kind", "step"} dicts).
SpawnFn = Callable[[int, int, List[dict]], Any]


def make_process_spawn(spec_base: dict) -> SpawnFn:
    """Spawn factory for real worker processes.

    ``spec_base`` carries everything a worker needs to build its replica
    from scratch: the config fields, the slot budget, the fault spec string,
    the checkpoint directory and the device.  Nothing else is shared with
    the supervisor: a replacement worker (``incarnation > 0``) re-warms from
    the on-disk checkpoint (``warm_start``), the first fleet builds from
    the seed."""

    def spawn(worker_id: int, incarnation: int, proc_faults: List[dict]):
        spec = dict(
            spec_base,
            worker_id=worker_id,
            incarnation=incarnation,
            proc_faults=[{"kind": f["kind"], "step": f["step"]} for f in proc_faults],
            warm_start=incarnation > 0,
        )
        return ProcessHandle(spec)

    return spawn
