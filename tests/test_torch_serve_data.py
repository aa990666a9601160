"""PyTorch port, serving across a ``(data, model)`` mesh: the slots split
over ``data`` (``launch.serve.SlotSplit``), on spawned gloo CPU ranks.

* At (2, 1) and (2, 2) the per-request streams of a spec-1 chain, a spec-4
  chain and a paged tree ``2,1`` (pages of 8, the model drafter, a shared
  16-token system prompt) equal the JAX reference ``ServeReplica``'s on a
  (1, 1) Auto-axis mesh (ROADMAP Queue C, R2; the reference's own sharded
  tests equate that mesh with its (2, 4) one), on every rank, from the
  same bridged weights.
* Each rank's cache holds its own slots' rows: D-th of the slots for the
  contiguous KV stripes and the plan rows, the whole pool on the paged
  plane (``cache_spec_for`` gives the pool no batch dim).  With 3 slots
  over 2 data groups the batch is replicated and the streams still equal
  the reference's.
* The serve CLI under ``torchrun`` at ``--data 2`` dumps the tokens of
  ``--data 1``.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_expert_parallel import run_ranks

ARCH = "qwen3-moe-235b-a22b"
PROMPT, GEN, N_REQ = 8, 6, 6
REPO = Path(__file__).resolve().parent.parent
# name -> (slots, spec width, tree branching, paged, page size, shared prefix, drafter)
CASES = {
    "chain1": (4, 1, None, False, 0, 0, "ngram"),
    "chain4": (4, 4, None, False, 0, 0, "ngram"),
    "paged_tree": (4, 0, (2, 1), True, 8, 16, "model"),
    "chain4_slots3": (3, 4, None, False, 0, 0, "ngram"),
}
MESHES = {2: (2, 1), 4: (2, 2)}


def _setup(name):
    from repro_torch.core.plans import TreePlan

    slots, spec, branching, paged, ps, shared, drafter = CASES[name]
    Tn = TreePlan.from_branching(list(branching)).num_nodes if branching else spec
    kw = dict(decode_plane=True, spec_tokens=Tn, paged=paged, **({"page_size": ps} if ps else {}))
    return slots, branching, kw, PROMPT + shared + GEN + Tn, shared, drafter


def _reference(name, d: Path, monkeypatch):
    """The reference replica over the queue: its streams, and its weights
    written as the reference's checkpoint leaves for the ranks."""
    import jax
    from jax.sharding import AxisType

    import repro.parallel.moe_parallel as jmp
    from repro.checkpoint.manager import _flatten
    from repro.configs import get_smoke_config
    from repro.core.plans import TreePlan
    from repro.launch.serve import ServeReplica
    from repro.models.model import Model
    from repro.runtime.fabric import Request
    from repro_torch.launch import serve

    if "check_rep" not in inspect.signature(jmp.shard_map).parameters:
        def shim(f, **kw):
            kw["check_vma"] = kw.pop("check_rep")
            return jax.shard_map(f, **kw)

        monkeypatch.setattr(jmp, "shard_map", shim)
    slots, branching, kw, max_len, shared, drafter = _setup(name)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **kw)
    params = Model(cfg).init(jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    tree = TreePlan.from_branching(list(branching)).validate() if branching else None
    rep = ServeReplica(cfg, mesh, slots, max_len, params, tree=tree, drafter=drafter)
    queue, out = list(serve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, N_REQ, shared)), {}
    while queue or rep.has_work():
        while queue and rep.free_slots():
            r = queue.pop(0)
            rep.admit(Request(rid=r.rid, prompt=r.prompt, gen=r.gen))
        for res in rep.step():
            out[str(res.rid)] = list(map(int, res.tokens))
    names, leaves, _ = _flatten(params)
    np.savez(d / f"weights_{name}.npz", **{n: np.asarray(v) for n, v in zip(names, leaves)})
    return out


def _rank(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.plans import TreePlan
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / f'rendezvous{world}'}", rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(*MESHES[world], "cpu")
        out = {}
        for name in CASES:
            slots, branching, kw, max_len, shared, drafter = _setup(name)
            cfg = dataclasses.replace(get_smoke_config(ARCH), **kw)
            params = params_from_numpy(cfg, dict(np.load(d / f"weights_{name}.npz")), "cpu", mesh)
            tree = TreePlan.from_branching(list(branching)).validate() if branching else None
            rep = serve.ServeReplica(cfg, slots, max_len, params, tree=tree, drafter=drafter, mesh=mesh)
            res = serve.serve_queue(rep, serve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, N_REQ, shared))
            out[name] = {
                "streams": {str(rid): r.tokens for rid, r in res.items()},
                "rows": {k: [int(c[k].shape[0]) for c in rep.cache] for k in ("k", "pk", "plan_e") if k in rep.cache[0]},
                "slots_served": [rep.split.rows.start, rep.split.rows.stop],
            }
        (d / f"out{world}_{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    d = tmp_path_factory.mktemp("serve_data")
    try:
        want = {name: _reference(name, d, mp) for name in CASES}
    finally:
        mp.undo()
    got = {}
    for world in MESHES:
        run_ranks(_rank, world, d, timeout=240)
        got[world] = [json.loads((d / f"out{world}_{r}.json").read_text()) for r in range(world)]
    return want, got


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_data_axis_streams_equal_the_reference_on_every_rank(served, name, world):
    want, got = served
    assert len(want[name]) == N_REQ
    for rank, out in enumerate(got[world]):
        assert out[name]["streams"] == want[name], (name, world, rank)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_each_rank_caches_its_own_slots(served, world):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import num_pages

    _, got = served
    D = MESHES[world][0]
    for rank, out in enumerate(got[world]):
        data = rank // MESHES[world][1]
        for name in ("chain1", "chain4"):
            slots = CASES[name][0]
            assert out[name]["rows"]["k"] == [slots // D] * 2, (name, rank)
            assert out[name]["rows"]["plan_e"] == [slots // D] * 2
            assert out[name]["slots_served"] == [data * slots // D, (data + 1) * slots // D]
        slots, _, kw, max_len, _, _ = _setup("paged_tree")
        cfg = dataclasses.replace(get_smoke_config(ARCH), **kw)
        assert out["paged_tree"]["rows"]["pk"] == [num_pages(cfg, slots, max_len) * cfg.page_size + 1] * 2
        assert out["paged_tree"]["rows"]["plan_e"] == [slots // D] * 2
        # 3 slots do not split over 2 data groups: every group serves them all
        assert out["chain4_slots3"]["rows"]["k"] == [3] * 2 and out["chain4_slots3"]["slots_served"] == [0, 3]


def _cli(args, cwd, launcher=()):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    cmd = [sys.executable, *launcher, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
           "--decode-plane", "--spec-tokens", "3", "--slots", "4", "--prompt-len", "16", "--gen", "8",
           "--device", "cpu", *args]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=180, env=env, cwd=cwd)


def test_cli_data_2_under_torchrun_dumps_the_data_1_tokens(tmp_path):
    two = _cli(["--data", "2", "--dump-tokens", str(tmp_path / "two.json")], tmp_path,
               ("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"))
    assert two.returncode == 0, two.stderr[-3000:]
    assert two.stdout.count("served 8 requests") == 1 and "'data': 2" in two.stdout
    one = _cli(["--dump-tokens", str(tmp_path / "one.json")], tmp_path)
    assert one.returncode == 0, one.stderr[-3000:]
    streams = json.loads((tmp_path / "two.json").read_text())
    assert len(streams) == 8 and streams == json.loads((tmp_path / "one.json").read_text())
