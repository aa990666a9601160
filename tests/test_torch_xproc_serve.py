"""PyTorch port, the real replica behind the cross-process fabric's wire.

Loopback workers (the worker loop in-process, a shared ``ManualClock``)
serve the smoke Qwen3-MoE through the port's ``CrossProcessFabric`` with
worker 0 killed before its launch 3 and the replacement re-warmed from a
checkpoint: the spec-4 chain, the paged int8 tree 2,1 with the model
drafter, and a 2-way fork JSON program.  Each run's streams, stats and
rounds equal the reference's ``CrossProcessFabric`` over the reference
``ServeReplica`` (an Auto-axis mesh, the ``check_rep`` shim) on the same
bridged weights.  Then real spawned workers (``kind="serve"`` on the CPU)
survive a SIGKILL with the in-process ``ServeFabric``'s streams, and the
CLI's ``--workers`` path keeps its exit-code contract.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core.plans import TreePlan as JTreePlan
from repro.launch.serve import ServeReplica as JReplica
from repro.runtime import fabric as j_fabric
from repro.runtime import faults as j_faults
from repro.runtime import transport as j_transport
from repro.runtime import worker as j_worker
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core.plans import TreePlan
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model
from repro_torch.runtime import fabric as t_fabric
from repro_torch.runtime import faults as t_faults
from repro_torch.runtime import transport as t_transport
from repro_torch.runtime import worker as t_worker

from tests._torch_program_cases import MOE, bridged, configs, host_mesh, shim_check_rep

ROOT = Path(__file__).resolve().parents[1]
SLOTS, GEN = 2, 10
FORK_SPEC = {"fork": 2, "join": "all", "segments": [{"kind": "json_schema", "schema": {"enum": [17, 42]}},
                                                    {"kind": "literal", "text": ";ok"}]}


def _requests(mod, vocab, n, program=None, sizes=(6, 9)):
    rng = np.random.default_rng(0)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, size=sizes[i % len(sizes)]).astype(np.int32), gen=GEN,
                        program=program) for i in range(n)]


def _loopback(fabric, faults, transport, worker, make, reqs, ckpt, params):
    clock = transport.ManualClock()
    fab = fabric.CrossProcessFabric(
        worker.make_loopback_spawn(make, clock, heartbeat_every=1.0), reqs,
        fabric.XFabricConfig(workers=2, slots_per_worker=SLOTS, heartbeat_every=1.0, heartbeat_miss_limit=4,
                             spawn_grace=0.0, poll_every=1.0, checkpoint_every=2, max_rounds=10_000),
        clock=clock, specs=faults.parse_faults("kill@step=3:replica=0"), ckpt=ckpt, params=params)
    fab.run()
    return fab


def _both(tmp_path, monkeypatch, *, tree=None, drafter="ngram", program=None, n_req=4, sizes=(6, 9), **fields):
    """The same loopback scenario through the reference's fabric over its
    replica and through the port's over the port's; asserts they agree and
    returns (port fabric, port restores)."""
    shim_check_rep(monkeypatch)
    width = TreePlan.from_branching(list(tree)).num_nodes if tree else 4
    cfg_j, cfg = configs(decode_plane=True, spec_tokens=width, **fields)
    params_j, params = bridged(cfg_j, cfg)
    dparams = None
    if drafter == "model":
        # the reference replica draws its drafter from PRNGKey(7): bridge the same weights
        _, dparams = bridged(*(dataclasses.replace(c, num_layers=1, spec_tokens=1, paged=False) for c in (cfg_j, cfg)),
                             key=7)
    max_len = 9 + GEN + width
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params_j)
    jckpt = JCheckpointManager(tmp_path / "reference", keep=2)
    ckpt = CheckpointManager(tmp_path / "port", keep=2, cfg=cfg)
    restores = {"reference": 0, "port": 0}

    def make_j(w, inc):
        p = params_j
        if inc > 0 and jckpt.latest_step() is not None:
            p = jckpt.restore(abstract, {})[0]
            restores["reference"] += 1
        return JReplica(cfg_j, host_mesh(), SLOTS, max_len, p, tree=JTreePlan.from_branching(list(tree)) if tree
                        else None, drafter=drafter, replica_id=w)

    def make_t(w, inc):
        p = params
        if inc > 0 and ckpt.latest_step() is not None:
            p = ckpt.restore("cpu")[0]
            restores["port"] += 1
        return tserve.ServeReplica(cfg, SLOTS, max_len, p, tree=TreePlan.from_branching(list(tree)) if tree else None,
                                   drafter=drafter, drafter_params=dparams, device="cpu", replica_id=w)

    want = _loopback(j_fabric, j_faults, j_transport, j_worker, make_j,
                     _requests(j_fabric, cfg.vocab_size, n_req, program, sizes), jckpt, params_j)
    got = _loopback(t_fabric, t_faults, t_transport, t_worker, make_t,
                    _requests(t_fabric, cfg.vocab_size, n_req, program, sizes), ckpt, params)
    assert {rid: (r.tokens, r.error) for rid, r in got.results.items()} == \
        {rid: (r.tokens, r.error) for rid, r in want.results.items()}
    assert got.stats == want.stats and got.round == want.round
    assert restores["port"] == restores["reference"] >= 1
    st = got.stats
    assert st["kills"] == 1 and st["spawns"] == 3 and st["requeued"] >= 1
    assert st["dropped"] == 0 and st["duplicates"] == 0 and st["checkpoints"] >= 1
    assert len(got.results) == n_req and all(r.error is None for r in got.results.values())
    return got


def test_chain_killed_worker_rewarmed_equals_reference(tmp_path, monkeypatch):
    _both(tmp_path, monkeypatch)


def test_paged_int8_tree_model_drafter_killed_worker_equals_reference(tmp_path, monkeypatch):
    # one prompt length of two full pages and a partial one: the reference compiles each length anew
    _both(tmp_path, monkeypatch, tree=(2, 1), drafter="model", sizes=(9,), paged=True, page_size=4, kv_dtype="int8",
          expert_dtype="int8")


def test_fork_program_killed_worker_equals_reference(tmp_path, monkeypatch):
    fab = _both(tmp_path, monkeypatch, program=FORK_SPEC, n_req=6)
    assert fab.stats["forks_started"] >= 2 and fab.stats["prog_tokens"] > 0
    assert fab.stats["prog_masked_emissions"] == 0


# ---------------------------------------------------------------------------
# the worker's replica build, and real worker processes
# ---------------------------------------------------------------------------


def _serve_spec(tmp_path, **kw):
    return dict(kind="serve", arch=MOE, smoke=True, decode_plane=True, spec_tokens=3, slots=SLOTS,
                max_len=9 + GEN + 3, seed=0, launch_timeout=30.0, ckpt_dir=str(tmp_path), heartbeat_every=0.25,
                device="cpu", worker_id=0, **kw)


def test_build_replica_cuts_depth_and_restores_a_replacement(tmp_path):
    """``num_layers`` cuts the depth; the first incarnation draws its
    weights from the seed, exactly the supervisor's; a replacement restores
    the newest committed step instead."""
    spec = _serve_spec(tmp_path, num_layers=1)
    rep, restored = t_worker._build_replica(spec)
    cfg = dataclasses.replace(get_smoke_config(MOE), decode_plane=True, spec_tokens=3, num_layers=1)
    assert restored == 0 and rep.cfg == cfg and rep.model.device.type == "cpu"
    seed = tserve.supervisor_params(cfg, torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(rep.params), _leaves(seed)))
    other = Model(cfg, device="cpu").init(1)
    CheckpointManager(tmp_path, cfg=cfg).save(5, other)
    rep, restored = t_worker._build_replica(dict(spec, warm_start=True))
    assert restored == 1
    assert all(torch.equal(a, b) for a, b in zip(_leaves(rep.params), _leaves(other)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def test_process_workers_sigkill_equals_in_process_fabric(tmp_path):
    """Two spawned ``kind="serve"`` workers on the CPU, worker 0 SIGKILLed
    before its launch 3: detected by heartbeats, its requests requeued to a
    replacement restored from the supervisor's checkpoint; the streams
    equal the in-process ``ServeFabric``'s from the same seed."""
    cfg = dataclasses.replace(get_smoke_config(MOE), decode_plane=True, spec_tokens=3)
    params = tserve.supervisor_params(cfg, torch.device("cpu"))
    reqs = _requests(t_fabric, cfg.vocab_size, 6)
    ckpt = CheckpointManager(tmp_path, keep=2, cfg=cfg)
    fab = t_fabric.CrossProcessFabric(
        t_transport.make_process_spawn(_serve_spec(tmp_path)), list(reqs),
        tserve.xfabric_config(2, SLOTS, checkpoint=True),
        clock=t_transport.MonotonicClock(), specs=t_faults.parse_faults("kill@step=3:replica=0"), ckpt=ckpt,
        params=params)
    results = fab.run()
    st = fab.stats
    assert st["kills"] == 1 and st["spawns"] == 3 and st["restores"] == 1 and st["requeued"] >= 1, st
    assert st["heartbeat_misses"] >= 12 and st["dropped"] == 0 and st["duplicates"] == 0, st
    make = tserve.make_replica_factory(cfg, SLOTS, 9 + GEN + 3, params, tserve.degrade_ladder(None, 3), device="cpu")
    want = t_fabric.ServeFabric(make, list(reqs), t_fabric.FabricConfig(n_replicas=1)).run()
    assert {rid: r.tokens for rid, r in results.items()} == {rid: r.tokens for rid, r in want.items()}
    assert all(r.error is None for r in results.values())


def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", MOE, "--smoke",
                           "--decode-plane", "--device", "cpu", *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


def test_cli_workers_kill_exits_zero(tmp_path):
    dump = tmp_path / "streams.json"
    out = _cli("--spec-tokens", "3", "--workers", "2", "--inject", "kill@step=7", "--dump-tokens", str(dump))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "1 kills" in out.stdout and "3 spawns (1 checkpoint re-warms)" in out.stdout, out.stdout
    assert "0 dropped, 0 duplicates" in out.stdout
    assert len(json.loads(dump.read_text())) == 8


def test_cli_workers_unexplained_error_exits_nonzero():
    """A fork program whose grammar allows one first token: every request
    is rejected by its worker, an error nothing injected explains."""
    out = _cli("--workers", "2", "--requests", "2", "--gen", "4",
               "--program", json.dumps({"fork": 2, "segments": [{"kind": "literal", "text": "ab"}]}))
    assert out.returncode == 1, out.stdout + out.stderr
    assert "FABRIC ERROR: 2 requests errored" in out.stdout


@pytest.mark.parametrize("flag", ["--model", "--data"])
def test_cli_refuses_workers_with_a_mesh(flag, capsys):
    with pytest.raises(SystemExit) as ei:
        tserve.main(["--arch", MOE, "--smoke", "--decode-plane", "--device", "cpu", "--workers", "2", flag, "2"])
    assert ei.value.code == 2
    assert "one-device worker processes" in capsys.readouterr().err
