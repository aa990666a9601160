"""PyTorch port, the cross-process fabric's supervision policy.

Every scenario of the reference's ``tests/test_xproc_fabric.py`` runs twice
on a shared ``ManualClock``: through the reference's ``CrossProcessFabric``
over its loopback ``SyntheticReplica`` workers, and through the port's over
its own.  The two runs must agree in every result (tokens, error, retries,
replica), in the whole ``stats`` dict and in the round count: heartbeat
deadlines, requeues, deadlines, backpressure, retirement and checkpoint
ledgers land at the same logical instants.  ``BENCH_decode.json``'s
``xproc`` counts (loopback, admission, real processes) are reproduced with
the port's modules, and real spawned worker processes serve cleanly and
survive a SIGKILL seen only as missed heartbeats.
"""
from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import programs as j_programs
from repro.runtime import fabric as j_fabric
from repro.runtime import faults as j_faults
from repro.runtime import transport as j_transport
from repro.runtime import worker as j_worker
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import programs as t_programs
from repro_torch.runtime import fabric as t_fabric
from repro_torch.runtime import faults as t_faults
from repro_torch.runtime import transport as t_transport
from repro_torch.runtime import worker as t_worker

ROOT = Path(__file__).resolve().parents[1]
GEN = 5

PKGS = {
    "reference": SimpleNamespace(fabric=j_fabric, faults=j_faults, transport=j_transport, worker=j_worker,
                                 programs=j_programs, ckpt=JCheckpointManager),
    "port": SimpleNamespace(fabric=t_fabric, faults=t_faults, transport=t_transport, worker=t_worker,
                            programs=t_programs, ckpt=CheckpointManager),
}


def _expected(rid, gen=GEN):
    return [rid * 1000 + i for i in range(gen + 1)]


def _fabric(pkg, faults="", n_req=6, *, workers=2, slots=2, miss_limit=4, queue_limit=0, deadlines=None,
            max_spawns=4, make_replica=None, program=None, ckpt=None, checkpoint_every=0, params=None,
            prompt=(0, 1, 2, 3), gen=GEN):
    """A loopback CrossProcessFabric of ``pkg`` on a ManualClock (one
    heartbeat a round, no boot holiday), not yet run."""
    clock = pkg.transport.ManualClock()
    make = make_replica or (lambda w, inc: pkg.worker.SyntheticReplica(slots, replica_id=w))
    spawn = pkg.worker.make_loopback_spawn(make, clock, heartbeat_every=1.0)
    reqs = [pkg.fabric.Request(rid=i, prompt=list(prompt), gen=gen, program=program) for i in range(n_req)]
    for rid, dl in (deadlines or {}).items():
        reqs[rid].deadline = dl
    return pkg.fabric.CrossProcessFabric(
        spawn, reqs,
        pkg.fabric.XFabricConfig(workers=workers, slots_per_worker=slots, heartbeat_every=1.0,
                                 heartbeat_miss_limit=miss_limit, spawn_grace=0.0, poll_every=1.0,
                                 queue_limit=queue_limit, max_spawns=max_spawns, checkpoint_every=checkpoint_every,
                                 max_rounds=10_000),
        clock=clock, specs=pkg.faults.parse_faults(faults), ckpt=ckpt, params=params,
    )


def _digest(fab):
    results = {rid: (list(r.tokens), r.error, r.retries, r.replica) for rid, r in fab.results.items()}
    return results, dict(fab.stats), fab.round


def _both(**kw):
    """Run the scenario on both packages; assert they agree; the port's fabric."""
    fabs = {}
    for name, pkg in PKGS.items():
        fabs[name] = fab = _fabric(pkg, **kw)
        fab.run()
    assert _digest(fabs["port"]) == _digest(fabs["reference"])
    return fabs["port"]


def _all_expected(fab, gen=GEN):
    for rid, r in fab.results.items():
        assert r.error is None and r.tokens == _expected(rid, gen), (rid, r)
    assert fab.stats["duplicates"] == 0 and fab.stats["dropped"] == 0


# ---------------------------------------------------------------------------
# loopback supervision, port against reference
# ---------------------------------------------------------------------------


def test_clean_run_exactly_once():
    fab = _both()
    assert len(fab.results) == 6
    _all_expected(fab)
    assert fab.stats["kills"] == 0 and fab.stats["spawns"] == 2


@pytest.mark.parametrize("faults,kills,spawns", [
    ("kill@step=3:replica=0", 1, 3),
    ("hang@step=2:replica=1", 1, 3),
    ("kill@step=1", 1, 3),  # wildcard: reserved by exactly one worker fleet-wide
])
def test_silent_worker_declared_dead_and_replaced(faults, kills, spawns):
    fab = _both(faults=faults)
    assert fab.stats["kills"] == kills and fab.stats["spawns"] == spawns
    assert len(fab.results) == 6
    _all_expected(fab)
    if faults.startswith("kill@step=3"):
        assert fab.stats["heartbeat_misses"] == 4 and fab.stats["requeued"] == 2


@pytest.mark.parametrize("secs,dead", [(2, False), (10, True)])
def test_slowpipe(secs, dead):
    """A delay below the liveness window kills nobody; one past it kills a
    healthy worker, whose stale messages are dropped by incarnation."""
    fab = _both(faults=f"slowpipe@secs={secs}:replica=0")
    assert (fab.stats["kills"] >= 1) == dead
    _all_expected(fab)


def test_deadline_expired_while_queued_costs_no_launch():
    fab = _both(n_req=3, workers=1, slots=1, deadlines={2: 3.0})
    assert fab.stats["deadline_expired"] == 1 and fab.stats["admitted"] == 2
    assert "queued" in fab.results[2].error and fab.results[2].tokens == []
    assert fab.results[0].tokens == _expected(0) and fab.results[1].tokens == _expected(1)


def test_backpressure_rejects_past_high_water_mark():
    fab = _both(n_req=8, queue_limit=4)
    assert fab.stats["backpressure_rejects"] == 4
    assert sorted(r.rid for r in fab.results.values() if r.error is not None) == [4, 5, 6, 7]


@pytest.mark.parametrize("name", list(PKGS))
def test_duplicate_rid_submission_rejected(name):
    pkg = PKGS[name]
    clock = pkg.transport.ManualClock()
    spawn = pkg.worker.make_loopback_spawn(lambda w, inc: pkg.worker.SyntheticReplica(1), clock)
    reqs = [pkg.fabric.Request(rid=0, prompt=[], gen=1), pkg.fabric.Request(rid=0, prompt=[], gen=1)]
    with pytest.raises(ValueError, match="unique"):
        pkg.fabric.CrossProcessFabric(spawn, reqs, pkg.fabric.XFabricConfig(workers=1), clock=clock)


def test_every_worker_retired_raises():
    """A persistent slowpipe keeps killing the only worker's replacements:
    out of capacity, at the same round and with the same stats."""
    fabs = {}
    for name, pkg in PKGS.items():
        fabs[name] = fab = _fabric(pkg, "slowpipe@secs=100", n_req=2, workers=1, slots=1, max_spawns=1)
        with pytest.raises(RuntimeError, match="capacity"):
            fab.run()
    assert _digest(fabs["port"]) == _digest(fabs["reference"])
    assert fabs["port"].stats["retired"] == 1


def test_legacy_crash_spec_is_process_death():
    """An in-process ``crash`` spec inside a worker has no exception channel
    to the supervisor: the worker loop dies, seen only as silence."""
    fabs = {}
    for name, pkg in PKGS.items():
        def make(w, inc, pkg=pkg):
            inj = pkg.faults.FaultInjector(pkg.faults.parse_faults("crash@step=2:replica=0")) if inc == 0 else None
            return pkg.worker.SyntheticReplica(2, replica_id=w, fault_hook=inj.check if inj else None)

        fabs[name] = fab = _fabric(pkg, n_req=4, workers=1, make_replica=make)
        fab.run()
    assert _digest(fabs["port"]) == _digest(fabs["reference"])
    assert fabs["port"].stats["kills"] == 1
    _all_expected(fabs["port"])


def test_checkpoint_ledger_written_on_round_one(tmp_path):
    """Round 1 always snapshots (a replacement always has a step to
    re-warm from); each package's manager writes the same steps and the
    same admission ledger."""
    fabs, extras = {}, {}
    for name, pkg in PKGS.items():
        ckpt = pkg.ckpt(tmp_path / name, keep=2)
        fabs[name] = fab = _fabric(pkg, n_req=2, workers=1, checkpoint_every=100, ckpt=ckpt,
                                   params={"w": [1.0, 2.0]})
        fab.run()
        steps = ckpt.all_steps()
        extras[name] = (steps, [json.loads((tmp_path / name / f"step_{s:08d}" / "manifest.json").read_text())
                                ["extra"] for s in steps])
    assert _digest(fabs["port"]) == _digest(fabs["reference"])
    assert extras["port"] == extras["reference"]
    assert fabs["port"].stats["checkpoints"] >= 1 and extras["port"][0][0] == 1


def _forking_replica(pkg, replicas):
    """The reference suite's SyntheticReplica honouring a fork program: K
    branch slots serve one rid off one admission, branch ``i`` streaming
    ``rid*1000 + i*100 + j``, published as ONE result at the join."""

    class ForkingSyntheticReplica(pkg.worker.SyntheticReplica):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.branch = [0] * self.slots
            self.fork_k, self.fork_done, self.seen_programs, self.admitted_rids = {}, {}, {}, []

        def in_flight(self):
            out, seen = [], set()
            for r in self.requests:
                if r is not None and r.rid not in seen:
                    seen.add(r.rid)
                    out.append(r)
            return out

        def admit(self, req):
            k = pkg.programs.program_slots(getattr(req, "program", None))
            free = [i for i, r in enumerate(self.requests) if r is None]
            if len(free) < k:
                raise RuntimeError("no free slot")
            self.seen_programs[req.rid] = getattr(req, "program", None)
            self.admitted_rids.append(req.rid)
            self.fork_k[req.rid], self.fork_done[req.rid] = k, {}
            for i, slot in enumerate(free[:k]):
                self.requests[slot], self.branch[slot] = req, i
                self.emitted[slot] = [req.rid * 1000 + i * 100]
                self.gen_left[slot] = int(req.gen)
            self.prefills += 1
            return free[0]

        def step(self):
            if not self.has_work():
                return []
            self.steps += 1
            self.launches += 1
            done = []
            for slot, req in enumerate(self.requests):
                if req is None:
                    continue
                i = self.branch[slot]
                self.emitted[slot].append(req.rid * 1000 + i * 100 + len(self.emitted[slot]))
                self.gen_left[slot] -= 1
                self.accepted_total += 1
                self.drafted_total += 1
                if self.gen_left[slot] <= 0:
                    self.fork_done[req.rid][i] = list(self.emitted[slot])
                    self.requests[slot] = None
                    self.emitted[slot] = []
                    if len(self.fork_done[req.rid]) == self.fork_k[req.rid]:
                        streams = self.fork_done.pop(req.rid)
                        del self.fork_k[req.rid]
                        done.append(pkg.worker.WireResult(req.rid, [t for b in sorted(streams) for t in streams[b]]))
            return done

    def make(w, inc):
        rep = ForkingSyntheticReplica(2, replica_id=w)
        replicas.append(rep)
        return rep

    return make


def test_kill_mid_fork_readmits_both_branches_exactly_once():
    spec = {"fork": 2, "join": "all", "segments": [{"kind": "literal", "text": "ab"}]}
    fabs, admits = {}, {}
    for name, pkg in PKGS.items():
        replicas = []
        fabs[name] = fab = _fabric(pkg, "kill@step=3:replica=0", n_req=4, make_replica=_forking_replica(pkg, replicas),
                                   program=spec)
        fab.run()
        admits[name] = [(rep.replica_id, rep.admitted_rids, rep.seen_programs) for rep in replicas]
    assert _digest(fabs["port"]) == _digest(fabs["reference"])
    assert admits["port"] == admits["reference"]
    fab = fabs["port"]
    assert fab.stats["kills"] == 1 and fab.stats["requeued"] >= 1
    for rid, r in fab.results.items():
        assert r.error is None and r.tokens == [rid * 1000 + b * 100 + j for b in range(2) for j in range(GEN + 1)]
    counts = {}
    for _, rids, programs in admits["port"]:
        assert all(p == spec for p in programs.values())
        for rid in rids:
            counts[rid] = counts.get(rid, 0) + 1
    assert sum(counts.values()) == 4 + sum(1 for n in counts.values() if n == 2) and 2 in counts.values()


def test_wire_request_program_passthrough():
    legacy = t_worker.WireRequest(1, [2, 3], 4)
    assert legacy.program is None and legacy._fields == j_worker.WireRequest._fields
    spec = {"fork": 2, "segments": [{"kind": "literal", "text": "ab"}]}
    assert t_worker.WireRequest(1, [2, 3], 4, spec).program == spec


# ---------------------------------------------------------------------------
# BENCH_decode.json's xproc section, with the port's modules
# ---------------------------------------------------------------------------


def _bench():
    return json.loads((ROOT / "BENCH_decode.json").read_text())["structural"]["xproc"]


def test_bench_xproc_loopback_and_admission():
    """``benchmarks/decode.py``'s loopback kill and its admission ledger."""
    pkg = PKGS["port"]
    fab = _fabric(pkg, "kill@step=3:replica=0", 6, prompt=(0, 1))
    res, st = fab.run(), fab.stats
    loopback = {
        "workers": 2, "requests": 6, "kills": st["kills"], "heartbeat_misses": st["heartbeat_misses"],
        "heartbeat_miss_limit": 4, "requeued": st["requeued"], "spawns": st["spawns"],
        "streams_byte_identical": int(all(res[i].error is None and res[i].tokens == _expected(i) for i in range(6))),
        "requests_dropped": st["dropped"], "duplicate_results": st["duplicates"],
    }
    fab = _fabric(pkg, "", 8, queue_limit=5, deadlines={4: 1.0}, prompt=(0, 1))
    res, st = fab.run(), fab.stats
    admission = {
        "deadline_expired": st["deadline_expired"], "backpressure_rejects": st["backpressure_rejects"],
        "served": sum(1 for r in res.values() if r.error is None), "answered": len(res),
        "launches_for_expired": 0 if "queued" in (res[4].error or "") else 1,
    }
    bench = _bench()
    assert loopback == bench["loopback"]
    assert admission == bench["admission"]


# ---------------------------------------------------------------------------
# real OS worker processes (multiprocessing spawn)
# ---------------------------------------------------------------------------


def _run_process(faults="", n_req=4, prompt=(0, 1, 2, 3)):
    spawn = t_transport.make_process_spawn(dict(kind="synthetic", slots=2, heartbeat_every=0.1))
    reqs = [t_fabric.Request(rid=i, prompt=list(prompt), gen=GEN) for i in range(n_req)]
    fab = t_fabric.CrossProcessFabric(
        spawn, reqs,
        t_fabric.XFabricConfig(workers=2, slots_per_worker=2, heartbeat_every=0.1, heartbeat_miss_limit=20,
                               spawn_grace=60.0, poll_every=0.02, max_rounds=500_000),
        clock=t_transport.MonotonicClock(), specs=t_faults.parse_faults(faults),
    )
    return fab, fab.run()


@pytest.fixture(scope="module")
def sigkilled():
    """``benchmarks/decode.py``'s process scenario: worker 0 SIGKILLs its
    own pid before its launch 3."""
    return _run_process("kill@step=3:replica=0", prompt=(0, 1))


def test_process_workers_clean_run():
    fab, res = _run_process()
    assert len(res) == 4 and fab.stats["kills"] == 0 and fab.stats["spawns"] == 2
    _all_expected(fab)
    assert fab.stats["launches"] > 0 and fab.stats["admitted"] == 4  # both farewells absorbed


def test_process_worker_sigkill_detected_by_heartbeats_only(sigkilled):
    """The pipe swallows the EOF, so the only possible detector is the
    heartbeat deadline: respawn, drain, exactly once."""
    fab, res = sigkilled
    assert fab.stats["kills"] == 1 and fab.stats["heartbeat_misses"] >= 20 and fab.stats["spawns"] == 3
    assert len(res) == 4
    _all_expected(fab)
    assert all(h is None for h in fab.handles)


def test_bench_xproc_process(sigkilled):
    fab, res = sigkilled
    st = fab.stats
    process = {
        "workers": 2, "requests": 4, "kills": st["kills"], "requeued": st["requeued"], "spawns": st["spawns"],
        "streams_byte_identical": int(all(res[i].error is None and res[i].tokens == _expected(i) for i in range(4))),
        "requests_dropped": st["dropped"], "duplicate_results": st["duplicates"],
    }
    assert process == _bench()["process"]
