"""PyTorch port, the in-process serve fabric and its checkpoints.

The supervisor policy (retry, backoff, requeue, poison budget, degrade,
exclude, capacity floor) is re-proven on the port's ``ServeFabric``,
``faults`` and ``straggler`` with the reference suite's fake replica, and
held against the reference's modules on the same specs.  Then the port's
replica serves through it on the CPU: fault-free, crashed (weights restored
from a checkpoint, the replica rebuilt) and with transient failures, every
stream byte-identical to the reference model's sequential greedy stream.
Checkpoints cross between the packages both ways, bf16 and int8 leaves
round-trip bit for bit without ``ml_dtypes``, a torn step falls back.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint.manager import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.models.model import Model as JModel
from repro.runtime import faults as j_faults
from repro.runtime import straggler as j_straggler
from repro_torch.checkpoint import CheckpointManager, leaves_from_params, load_step_dir, params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model
from repro_torch.runtime.fabric import FabricConfig, Request, Result, ServeFabric
from repro_torch.runtime.faults import (
    FaultInjector,
    FaultSpec,
    ReplicaCrash,
    TransientLaunchError,
    parse_faults,
)
from repro_torch.runtime.straggler import Mitigation, StragglerDetector

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-moe-235b-a22b"


# ---------------------------------------------------------------------------
# fault spec grammar + injector determinism, against the reference's modules
# ---------------------------------------------------------------------------


def test_parse_faults_grammar():
    specs = parse_faults(
        "crash@step=7, launch@step=3:replica=1:times=2,"
        "stall@secs=9:times=4, poison@rid=0, crash@step=5:shrink=1"
    )
    assert [s.kind for s in specs] == ["crash", "launch", "stall", "poison", "crash"]
    assert specs[0].step == 7 and specs[0].times == 1 and not specs[0].shrink
    assert specs[1].replica == 1 and specs[1].times == 2
    assert specs[2].step is None and specs[2].secs == 9.0  # wildcard stall
    assert specs[3].rid == 0 and specs[3].times == 0  # poison persists
    assert specs[4].shrink
    assert parse_faults("") == [] and parse_faults("  ") == []


@pytest.mark.parametrize("text", [
    "crash@step=7,launch@step=3:replica=1:times=2,stall@secs=9:times=4,poison@rid=0,crash@step=5:shrink=1",
    "kill@step=7,hang@step=3:replica=1,slowpipe@secs=2:replica=0,stall@step=2:secs=9:times=4",
])
def test_parse_faults_equals_reference(text):
    mine = [dataclasses.asdict(s) for s in parse_faults(text)]
    assert mine == [dataclasses.asdict(s) for s in j_faults.parse_faults(text)]
    split = [[dataclasses.asdict(s) for s in g] for g in j_faults.split_process_specs(j_faults.parse_faults(text))]
    from repro_torch.runtime.faults import split_process_specs

    assert [[dataclasses.asdict(s) for s in g] for g in split_process_specs(parse_faults(text))] == split


def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec(kind="meteor")
    with pytest.raises(ValueError):
        FaultSpec(kind="crash")  # crash needs a step
    with pytest.raises(ValueError):
        FaultSpec(kind="poison")  # poison needs a rid
    FaultSpec(kind="stall", secs=3.0)  # wildcard stall is legal
    with pytest.raises(ValueError):
        parse_faults("stall@bogus=1")


def test_injector_explicit_specs_fire_deterministically():
    specs = parse_faults("crash@step=2:replica=1,stall@secs=5:times=2,launch@step=3")
    inj = FaultInjector(specs)
    assert inj.check(0, 1) == 5.0  # wildcard stall, firing 1/2
    assert inj.check(1, 1) == 5.0  # firing 2/2 -> disarmed
    assert inj.check(0, 2) == 0.0  # crash spec filtered to replica 1
    with pytest.raises(ReplicaCrash):
        inj.check(1, 2)
    with pytest.raises(TransientLaunchError):
        inj.check(0, 3)
    assert inj.check(0, 3) == 0.0  # launch spec fired its once
    assert [k for _, _, k in inj.log] == ["stall", "stall", "crash", "launch"]


def test_injector_poison_fires_only_at_admission_with_matching_rid():
    inj = FaultInjector(parse_faults("poison@rid=7"))
    assert inj.check(0, 1, "launch", (7,)) == 0.0  # launches never poisoned
    assert inj.check(0, 1, "admit", (3,)) == 0.0   # other rids untouched
    for _ in range(3):  # times=0: persists forever
        with pytest.raises(TransientLaunchError) as ei:
            inj.check(0, 1, "admit", (7,))
        assert ei.value.rid == 7


def _verdict(inj, replica, step):
    try:
        inj.check(replica, step)
        return "ok"
    except Exception as err:  # the two packages' exception classes differ
        return type(err).__name__


def test_injector_seeded_layer_is_call_order_independent_and_equals_reference():
    """Randomized verdicts derive from (seed, replica, step) alone: two
    injectors probed in different orders agree, and agree with the
    reference's injector on every probe."""
    probes = [(r, s) for r in range(3) for s in range(1, 30)]
    a = FaultInjector(seed=11, p_crash=0.15, p_transient=0.2)
    b = FaultInjector(seed=11, p_crash=0.15, p_transient=0.2)
    ref = j_faults.FaultInjector(seed=11, p_crash=0.15, p_transient=0.2)
    va = {p: _verdict(a, *p) for p in probes}
    assert va == {p: _verdict(b, *p) for p in reversed(probes)}
    assert va == {p: _verdict(ref, *p) for p in probes}
    assert "ReplicaCrash" in va.values() and "TransientLaunchError" in va.values()
    c = FaultInjector(seed=12, p_crash=0.15, p_transient=0.2)
    assert {p: _verdict(c, *p) for p in probes} != va


def test_straggler_detector_equals_reference():
    """The same step-time trace gives the same verdicts, EWMA and flag
    counters in both packages, across a rebase."""
    rng = np.random.default_rng(4)
    mine = StragglerDetector(n_workers=4, alpha=0.5, threshold=1.5, patience=2, warmup=2, clock=lambda: 0.0)
    ref = j_straggler.StragglerDetector(n_workers=4, alpha=0.5, threshold=1.5, patience=2, warmup=2,
                                        clock=lambda: 0.0)
    for step in range(30):
        times = 1.0 + 0.1 * rng.random(mine.n_workers)
        if step > 5:
            times[-1] *= 3.0
        got = mine.observe(times)
        want = ref.observe(times)
        assert {w: a.value for w, a in got.items()} == {w: a.value for w, a in want.items()}
        np.testing.assert_array_equal(mine.ewma, ref.ewma)
        if step == 12:
            mine.rebase([0, 1, 3])
            ref.rebase([0, 1, 3])
    assert Mitigation.EXCLUDE.value in {v for _, _, v in mine.flag_log}
    assert mine.flag_log == ref.flag_log


# ---------------------------------------------------------------------------
# supervisor policy against a fake replica: retry, backoff, requeue-on-crash,
# poison budget, exclusion, capacity floor
# ---------------------------------------------------------------------------


class FakeReplica:
    """The reference suite's stand-in honouring the ServeReplica duck type:
    one token per step per slot, deterministic stream ``rid*1000 + i``, so
    a dropped, duplicated or corrupted token shows."""

    def __init__(self, replica_id, *, slots=1, fault_hook=None, launch_timeout=None):
        self.replica_id = replica_id
        self.fault_hook = fault_hook
        self.launch_timeout = launch_timeout
        self.requests = [None] * slots
        self.emitted = [[] for _ in range(slots)]
        self.left = [0] * slots
        self.steps = 0
        self.launches = 0
        self.prefills = 0
        self.accepted_total = 0
        self.drafted_total = 0
        self.prefill_ms = 0.0
        self.agreements = []
        self.last_stall = 0.0

    def free_slots(self):
        return [b for b, r in enumerate(self.requests) if r is None]

    def in_flight(self):
        return [r for r in self.requests if r is not None]

    def has_work(self):
        return any(r is not None for r in self.requests)

    def snapshot_meta(self):
        return {"steps": self.steps, "rids": [r.rid for r in self.in_flight()]}

    def admit(self, req):
        if self.fault_hook is not None:
            self.fault_hook(self.replica_id, self.steps + 1, "admit", (req.rid,))
        b = self.free_slots()[0]
        self.requests[b] = req
        self.emitted[b] = [req.rid * 1000]
        self.left[b] = req.gen
        self.prefills += 1

    def step(self):
        step_no = self.steps + 1
        self.last_stall = 0.0
        if self.fault_hook is not None:
            rids = tuple(r.rid for r in self.in_flight())
            stall = float(self.fault_hook(self.replica_id, step_no, "launch", rids) or 0.0)
            if self.launch_timeout is not None and stall >= self.launch_timeout:
                raise TransientLaunchError(f"launch exceeded the {self.launch_timeout}s timeout")
            self.last_stall = stall
        self.steps = step_no
        self.launches += 1
        done = []
        for b, req in enumerate(self.requests):
            if req is None:
                continue
            self.emitted[b].append(req.rid * 1000 + len(self.emitted[b]))
            self.accepted_total += 1
            self.drafted_total += 1
            self.left[b] -= 1
            if self.left[b] <= 0:
                done.append(Result(rid=req.rid, tokens=list(self.emitted[b]), replica=self.replica_id))
                self.requests[b] = None
                self.emitted[b] = []
        return done


def _expected_tokens(rid, gen):
    return [rid * 1000 + i for i in range(gen + 1)]


def _run_fake(specs, cfg, *, n_req=4, gen=5, detector=None, slots=1):
    inj = FaultInjector(parse_faults(specs)) if specs else None
    reqs = [Request(rid=i, prompt=[i], gen=gen) for i in range(n_req)]
    fabric = ServeFabric(
        lambda w, level, params, shrunk: FakeReplica(
            w, slots=slots, fault_hook=inj.check if inj else None, launch_timeout=cfg.launch_timeout),
        reqs, cfg, detector=detector,
    )
    return fabric.run(), fabric.stats, reqs


def test_fake_fabric_serves_exactly_once_without_faults():
    results, stats, reqs = _run_fake("", FabricConfig(n_replicas=2))
    assert set(results) == {r.rid for r in reqs}
    for r in reqs:
        assert results[r.rid].tokens == _expected_tokens(r.rid, r.gen)
    assert stats["dropped"] == 0 and stats["duplicates"] == 0


def test_fake_fabric_crash_requeues_in_flight_exactly_once():
    results, stats, reqs = _run_fake("crash@step=3", FabricConfig(n_replicas=1, rejoin_after=1), n_req=3)
    assert stats["crashes"] == 1 and stats["rejoins"] == 1
    assert stats["rewarm_prefills"] >= 1  # the in-flight prompt was replayed
    assert stats["dropped"] == 0 and stats["duplicates"] == 0
    for r in reqs:  # discarded partial buffer regenerated identically
        assert results[r.rid].tokens == _expected_tokens(r.rid, r.gen)


def test_fake_fabric_transient_backoff_then_escalation():
    """4 consecutive transient failures at the same launch: 3 retries with
    exponential cooldowns (1, 2, 4 rounds), then escalation to a crash."""
    results, stats, reqs = _run_fake(
        "launch@step=2:times=4",
        FabricConfig(n_replicas=1, max_launch_retries=3, backoff_base=1, backoff_cap=8), n_req=2)
    assert stats["transient_failures"] == 4
    assert stats["backoff_rounds"] == 1 + 2 + 4
    assert stats["crashes"] == 1 and stats["rejoins"] == 1
    assert stats["dropped"] == 0
    for r in reqs:
        assert results[r.rid].tokens == _expected_tokens(r.rid, r.gen)


def test_fake_fabric_poisoned_request_rejected_not_crash_looped():
    results, stats, reqs = _run_fake("poison@rid=1", FabricConfig(n_replicas=1, request_retry_budget=2), n_req=3)
    assert stats["poisoned"] == 1 and stats["crashes"] == 0
    bad = results[1]
    assert bad.error is not None and bad.tokens == [] and bad.retries == 3
    for r in reqs:
        if r.rid != 1:
            assert results[r.rid].error is None
            assert results[r.rid].tokens == _expected_tokens(r.rid, r.gen)
    assert stats["dropped"] == 0


def test_fake_fabric_timeout_stall_fails_fast_and_recovers():
    results, stats, reqs = _run_fake("stall@step=2:secs=60:times=1",
                                     FabricConfig(n_replicas=1, launch_timeout=30.0), n_req=2)
    assert stats["timeouts"] == 1 and stats["transient_failures"] == 1
    assert stats["crashes"] == 0 and stats["dropped"] == 0
    for r in reqs:
        assert results[r.rid].tokens == _expected_tokens(r.rid, r.gen)


def test_fake_fabric_persistent_straggler_excluded_other_replica_drains():
    det = StragglerDetector(n_workers=2, alpha=0.7, threshold=1.5, patience=2, warmup=1)
    results, stats, reqs = _run_fake(
        "stall@secs=9:times=0:replica=1",
        FabricConfig(n_replicas=2, max_degrade_level=0, synthetic_step_times=True), n_req=6, detector=det)
    assert stats["excluded"] == 1
    assert stats["dropped"] == 0 and stats["duplicates"] == 0
    for r in reqs:
        assert results[r.rid].tokens == _expected_tokens(r.rid, r.gen)
    assert all(results[r.rid].replica == 0 for r in reqs if results[r.rid].replica >= 0)


def test_fake_fabric_straggler_descends_the_ladder_before_exclusion():
    """A persistently slow replica first drops speculation levels (each a
    rebuild through the factory at the next level), then is excluded."""
    det = StragglerDetector(n_workers=2, alpha=0.7, threshold=1.5, patience=2, warmup=1)
    levels = []

    def make(w, level, params, shrunk):
        levels.append((w, level))
        return FakeReplica(w, fault_hook=inj.check)

    inj = FaultInjector(parse_faults("stall@secs=9:times=0:replica=1"))
    reqs = [Request(rid=i, prompt=[i], gen=8) for i in range(8)]
    fabric = ServeFabric(make, reqs, FabricConfig(n_replicas=2, max_degrade_level=2, synthetic_step_times=True),
                         detector=det)
    results = fabric.run()
    st = fabric.stats
    assert [d[1:] for d in st["degradations"]] == [(0, 1), (1, 2)]
    assert (1, 1) in levels and (1, 2) in levels
    assert st["excluded"] == 1 and st["dropped"] == 0 and st["duplicates"] == 0
    for r in reqs:
        assert results[r.rid].tokens == _expected_tokens(r.rid, r.gen)


def test_fake_fabric_capacity_floor_resurrects_retired_replica():
    """All replicas retired with work still queued: the fabric resurrects
    one at the ladder bottom rather than deadlock."""
    results, stats, reqs = _run_fake("crash@step=1:times=2", FabricConfig(n_replicas=1, max_rejoins=0), n_req=2)
    assert stats["crashes"] == 2 and stats["retired"] == 2
    assert stats["dropped"] == 0
    for r in reqs:
        assert results[r.rid].tokens == _expected_tokens(r.rid, r.gen)


def test_fake_fabric_rejects_duplicate_request_ids():
    with pytest.raises(ValueError):
        ServeFabric(lambda *a: FakeReplica(0),
                    [Request(rid=1, prompt=[], gen=1), Request(rid=1, prompt=[], gen=1)], FabricConfig())


def test_fake_fabric_checkpoints_the_admission_ledger(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    reqs = [Request(rid=i, prompt=[i], gen=5) for i in range(3)]
    fabric = ServeFabric(lambda w, level, params, shrunk: FakeReplica(w), reqs,
                         FabricConfig(n_replicas=1, checkpoint_every=2), ckpt=ckpt,
                         params={"w": np.arange(6, dtype=np.float32).reshape(2, 3)})
    fabric.run()
    assert fabric.stats["checkpoints"] >= 2 and len(ckpt.all_steps()) == 2
    params, opt, step, extra = ckpt.restore()
    np.testing.assert_array_equal(params["w"], np.arange(6, dtype=np.float32).reshape(2, 3))
    assert opt == {} and step == extra["round"] and "0" in extra["ledger"]


# ---------------------------------------------------------------------------
# the port's replica through the fabric: byte identity under faults
# ---------------------------------------------------------------------------

GEN, WIDTH = 6, 3


@pytest.fixture(scope="module")
def env():
    cfg_j = dataclasses.replace(j_smoke(ARCH), decode_plane=True, spec_tokens=WIDTH)
    params_j = JModel(cfg_j).init(jax.random.PRNGKey(0))
    names, leaves, _ = _flatten(params_j)
    arrays = {n: np.asarray(v) for n, v in zip(names, leaves)}
    cfg = dataclasses.replace(t_smoke(ARCH), decode_plane=True, spec_tokens=WIDTH)
    rng = np.random.default_rng(0)
    requests = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=(6, 9)[i % 2]).astype(np.int32),
                        gen=GEN) for i in range(4)]
    max_len = 9 + GEN + WIDTH
    # the reference model's sequential greedy streams: the oracle every run must equal
    model = JModel(dataclasses.replace(cfg_j, spec_tokens=1))
    pre, dec = jax.jit(model.prefill), jax.jit(model.decode_tokens)
    oracle = {}
    for req in requests:
        lg, cache = pre(params_j, jnp.asarray(req.prompt)[None], model.init_cache(1, max_len))
        tok, length, toks = int(jnp.argmax(lg[0])), len(req.prompt), []
        toks.append(tok)
        for _ in range(req.gen):
            logits, cache = dec(params_j, cache, jnp.asarray([[tok]], jnp.int32), jnp.asarray([length], jnp.int32),
                                jnp.zeros((1,), jnp.int32))
            tok = int(jnp.argmax(logits[0, 0]))
            toks.append(tok)
            length += 1
        oracle[req.rid] = toks
    return dict(cfg=cfg, arrays=arrays, params=params_from_numpy(cfg, arrays, "cpu"), requests=requests,
                max_len=max_len, oracle=oracle)


def _run_port(env, specs, *, ckpt=None, checkpoint_every=0, tree=None):
    inj = FaultInjector(parse_faults(specs)) if specs else None
    ladder = tserve.degrade_ladder(tree, WIDTH)
    make = tserve.make_replica_factory(env["cfg"], 2, env["max_len"], env["params"], ladder,
                                       fault_hook=inj.check if inj else None, launch_timeout=30.0, device="cpu")
    fabric = ServeFabric(
        make, list(env["requests"]),
        FabricConfig(n_replicas=1, launch_timeout=30.0, checkpoint_every=checkpoint_every,
                     max_degrade_level=len(ladder) - 1, synthetic_step_times=True),
        ckpt=ckpt, restore_params=(lambda mgr: mgr.restore("cpu")[0]) if ckpt else None, params=env["params"])
    return fabric.run(), fabric.stats


def _assert_byte_identical(results, env):
    for req in env["requests"]:
        res = results[req.rid]
        assert res.error is None, f"rid {req.rid} errored: {res.error}"
        assert res.tokens == env["oracle"][req.rid], f"rid {req.rid}: {res.tokens} != {env['oracle'][req.rid]}"


def test_port_fabric_matches_reference_sequential_greedy(env):
    results, stats = _run_port(env, "")
    assert set(results) == set(env["oracle"])
    _assert_byte_identical(results, env)
    assert stats["dropped"] == 0 and stats["duplicates"] == 0 and stats["launches"] > 0


def test_port_crash_mid_decode_recovers_byte_identical(env, tmp_path):
    """The replica crashes mid-decode with requests in flight; the rebuilt
    replica's weights come back through the port's checkpoint and it
    re-warms by replaying admission: every stream still byte-identical."""
    ckpt = CheckpointManager(tmp_path / "fab", keep=2, cfg=env["cfg"])
    results, stats = _run_port(env, "crash@step=4", ckpt=ckpt, checkpoint_every=2)
    assert stats["crashes"] == 1 and stats["rejoins"] == 1
    assert stats["rewarm_prefills"] >= 1 and stats["restores"] >= 1
    assert stats["dropped"] == 0 and stats["duplicates"] == 0
    _assert_byte_identical(results, env)
    _, _, step, extra = ckpt.restore("cpu")
    assert "ledger" in extra and extra["round"] == step
    assert len(ckpt.all_steps()) == 2 and len(ckpt.restores) >= 2


def test_port_transient_failures_and_timeout_byte_identical(env):
    results, stats = _run_port(env, "launch@step=2:times=2,stall@step=5:secs=60:times=1")
    assert stats["transient_failures"] == 3 and stats["timeouts"] == 1
    assert stats["backoff_rounds"] >= 2 and stats["crashes"] == 0
    assert stats["dropped"] == 0
    _assert_byte_identical(results, env)


def test_replica_factory_refuses_the_elastic_rebuild(env):
    with pytest.raises(NotImplementedError, match="later slice"):
        tserve.make_replica_factory(env["cfg"], 2, env["max_len"], env["params"], [(None, WIDTH)], shrink_to=(1, 1))
    tree = tserve.TreePlan.from_branching([2, 1])
    assert [(t is not None, w) for t, w in tserve.degrade_ladder(tree, 4)] == [(True, 4), (False, 3), (False, 1)]


def test_cli_fabric_inject_and_program_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "tokens.json"
    spec = json.dumps({"segments": [{"kind": "json_schema", "schema": {
        "type": "object", "properties": {"a": {"type": "integer", "maxDigits": 2}, "b": {"type": "boolean"}}}}]})
    code = tserve.main(["--arch", ARCH, "--smoke", "--decode-plane", "--spec-tokens", "3", "--slots", "2",
                        "--prompt-len", "8", "--gen", "24", "--requests", "3", "--device", "cpu",
                        "--fabric", "2", "--inject", "crash@step=3", "--checkpoint-dir", str(tmp_path / "ck"),
                        "--program", spec, "--dump-tokens", str(out)])
    text = capsys.readouterr().out
    assert code == 0, text
    assert "served 3 requests on 2x2 slots" in text
    assert "0 masked emissions" in text and "1 crashes, 1 rejoins" in text
    assert "0 dropped, 0 duplicates" in text
    streams = json.loads(out.read_text())
    assert sorted(streams) == ["0", "1", "2"]
    assert (tmp_path / "ck").is_dir()


# ---------------------------------------------------------------------------
# checkpoints: the reference's format, both ways
# ---------------------------------------------------------------------------


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch,quant", [(ARCH, {}), (ARCH, dict(kv_dtype="int8", expert_dtype="int8")),
                                        ("recurrentgemma-2b", {}), ("mamba2-2.7b", {})])
def test_reference_step_restores_into_the_port_and_back(arch, quant, tmp_path):
    """A reference step directory restores into the port leaf for leaf at
    f32 (int8 twins bit for bit), and the port's save of those params
    restores into the reference's CheckpointManager, every leaf equal to
    the reference's own."""
    cfg_j = dataclasses.replace(j_smoke(arch), **quant)
    params_j = JModel(cfg_j).init(jax.random.PRNGKey(1))
    JCheckpointManager(tmp_path / "ref", keep=1).save(3, params_j, {}, extra={"from": "reference"})
    cfg = dataclasses.replace(t_smoke(arch), **quant)
    mine = CheckpointManager(tmp_path / "ref", cfg=cfg)
    params, opt, step, extra = mine.restore("cpu")
    assert step == 3 and extra == {"from": "reference"} and opt == {}
    names, leaves, _ = _flatten(params_j)
    _equal_trees(params, params_from_numpy(cfg, {n: np.asarray(v) for n, v in zip(names, leaves)}, "cpu"))

    CheckpointManager(tmp_path / "port", cfg=cfg).save(5, params, {}, extra={"from": "port"})
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params_j)
    back, _, step, extra = JCheckpointManager(tmp_path / "port").restore(abstract, {})
    assert step == 5 and extra == {"from": "port"}
    for (n, a), b in zip(zip(names, leaves), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=n)
    port_names = [n for n, _ in leaves_from_params(cfg, params)]
    assert port_names == names  # the reference's leaf names, in its flatten order


def test_port_bf16_and_int8_save_round_trips_bitwise_without_ml_dtypes(tmp_path):
    """In a process that never imports ml_dtypes (nor jax): bf16 leaves go
    out as ``<V2`` with manifest dtype ``bfloat16`` and come back as bf16
    bits; int8 twins and their f32 scales bit for bit."""
    script = f"""
import dataclasses, json, sys
import numpy as np, torch
sys.path.insert(0, {str(ROOT / 'src')!r})
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.models.moe import quantize_expert_stacks
cfg = dataclasses.replace(get_smoke_config("{ARCH}"), dtype="bfloat16", kv_dtype="int8", expert_dtype="int8")
p = Model(cfg, "cpu").init(0)
for layer in p["layers"]:
    layer["moe"].update(quantize_expert_stacks(layer["moe"]))
mgr = CheckpointManager({str(tmp_path)!r}, cfg=cfg)
d = mgr.save(1, p, {{}})
man = json.loads((d / "manifest.json").read_text())
kinds = sorted({{r["dtype"] for r in man["params"]}})
head = open(d / man["params"][[r["dtype"] for r in man["params"]].index("bfloat16")]["file"], "rb").read(80)
q = mgr.restore("cpu")[0]
def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return all(same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8) if a.is_floating_point() else a,
                                              b.view(torch.uint8) if b.is_floating_point() else b)
print(json.dumps(dict(kinds=kinds, v2=b"'<V2'" in head, same=same(p, q),
                      ml_dtypes="ml_dtypes" in sys.modules, jax="jax" in sys.modules)))
"""
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got == dict(kinds=["bfloat16", "float32", "int8"], v2=True, same=True, ml_dtypes=False, jax=False)


def test_bridge_reads_a_bf16_leaf_stored_as_v2(tmp_path):
    """The reference's np.save of a bf16 array writes ``<V2``; the bridge
    reads such a leaf as bf16 bits (it used to raise), and refuses raw
    2-byte elements whose manifest type is not bfloat16."""
    cfg_j = j_smoke(ARCH)
    params_j = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
                            JModel(cfg_j).init(jax.random.PRNGKey(2)))
    d = JCheckpointManager(tmp_path, keep=1).save(1, params_j, {})
    man = json.loads((d / "manifest.json").read_text())
    assert {r["dtype"] for r in man["params"]} == {"bfloat16"}
    assert np.load(d / man["params"][0]["file"]).dtype == np.dtype("V2")
    cfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16")
    params = load_step_dir(cfg, d, "cpu")
    names, leaves, _ = _flatten(params_j)
    want = params_from_numpy(cfg, {n: np.asarray(v, np.float32) for n, v in zip(names, leaves)}, "cpu")
    _equal_trees(params, want)
    man["params"][0]["dtype"] = "float16"
    (d / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="manifest says"):
        load_step_dir(cfg, d, "cpu")


def test_torn_latest_step_falls_back_to_the_one_before(tmp_path):
    cfg = t_smoke(ARCH)
    params = Model(cfg, "cpu").init(0)
    mgr = CheckpointManager(tmp_path, keep=3, cfg=cfg)
    mgr.save(1, params, {}, extra={"round": 1})
    later = Model(cfg, "cpu").init(1)
    d = mgr.save(2, later, {}, extra={"round": 2})
    leaf = sorted(d.glob("params.*.npy"))[3]
    leaf.write_bytes(leaf.read_bytes()[:-16])  # a truncated leaf: torn data
    restored, _, step, extra = mgr.restore("cpu")
    assert step == 1 and extra == {"round": 1}
    _equal_trees(restored, params)
    with pytest.raises(Exception):
        mgr.restore("cpu", step=2)  # an explicit step stays strict
    (tmp_path / "tmp.step_00000009").mkdir()
    mgr.save(3, params, {})
    assert not list(tmp_path.glob("tmp.step_*")) and mgr.all_steps() == [1, 2, 3]
    mgr.save(4, params, {})
    assert mgr.all_steps() == [2, 3, 4]


def test_unchanged_weights_are_linked_not_written_again(tmp_path):
    """A second save of the same tensors, unwritten since, hard-links the
    first step's leaf files (0 bytes written); an in-place write is seen
    and the next save writes every leaf anew; a step restores whole after
    the step it linked from is collected."""
    cfg = t_smoke(ARCH)
    params = Model(cfg, "cpu").init(0)
    mgr = CheckpointManager(tmp_path, keep=2, cfg=cfg)
    first = mgr.save(1, params, {})
    second = mgr.save(2, params, {"o": np.ones(3, np.float32)})
    files = sorted(p.name for p in first.glob("params.*.npy"))
    assert files == sorted(p.name for p in second.glob("params.*.npy"))
    assert all((first / f).stat().st_ino == (second / f).stat().st_ino for f in files)
    (_, _, nbytes, written), (_, _, nbytes2, written2) = mgr.saves
    assert written == nbytes and written2 == 12 and nbytes2 == nbytes + 12
    embed = params["embed"].clone()
    params["embed"].add_(1.0)  # an in-place write bumps the version counter
    third = mgr.save(3, params, {})
    assert not any((second / f).stat().st_ino == (third / f).stat().st_ino for f in files)
    assert mgr.saves[-1][3] == mgr.saves[-1][2] and mgr.all_steps() == [2, 3]
    restored, opt, step, _ = mgr.restore("cpu", step=2)  # step 1, which it linked from, is gone
    params["embed"].copy_(embed)
    _equal_trees(restored, params)
    np.testing.assert_array_equal(opt["o"], np.ones(3, np.float32))


def test_restore_places_the_weights_on_the_card_by_default(tmp_path):
    """``restore()`` with no device means the card, as every entry point
    of the port: with no card it raises rather than fill host memory."""
    cfg = t_smoke(ARCH)
    mgr = CheckpointManager(tmp_path, cfg=cfg)
    mgr.save(1, Model(cfg, "cpu").init(0), {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore()
    else:
        assert mgr.restore()[0]["embed"].device.type == "cuda"
