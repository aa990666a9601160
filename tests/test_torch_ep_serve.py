"""PyTorch port, serving on the expert-parallel plane: the mesh-bound
``ServeReplica`` at mesh (1, 2) (two gloo processes, spawned) gives the
per-request streams of the JAX reference's ``ServeReplica`` on the same
queue and the same bridged weights, on every rank, at spec widths 1 and 4;
the serve CLI at ``--model 2 --device cpu`` under ``torchrun`` serves the
same streams as at ``--model 1``, rank 0 alone printing and dumping (a spec-4
chain, and the paged plane with a draft tree and the model drafter); and the
CLI refuses ``--data 2`` and ``--model 2`` without a launcher (exit 2).
Streams are compared exactly.
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
SLOTS, PROMPT, GEN, N_REQ = 2, 8, 6, 4
REPO = Path(__file__).resolve().parent.parent


def _serve_worker(rank: int, world: int, d: str) -> None:
    """One rank of the mesh-bound replica; writes its streams per width."""
    import torch.distributed as dist

    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh

    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(1, world, "cpu")
        out = {}
        for Tn in (1, 4):
            cfg = dataclasses.replace(get_smoke_config(ARCH), decode_plane=True, spec_tokens=Tn)
            arrays = dict(np.load(d / f"weights{Tn}.npz"))
            params = params_from_numpy(cfg, arrays, "cpu", mesh)
            assert params["layers"][0]["moe"]["w_gate"].shape[0] == cfg.num_experts // world
            rep = serve.ServeReplica(cfg, SLOTS, PROMPT + GEN + Tn, params, drafter="ngram", mesh=mesh)
            res = serve.serve_queue(rep, serve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, N_REQ))
            out[str(Tn)] = {str(rid): r.tokens for rid, r in res.items()}
        (d / f"streams{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _reference_streams(Tn, monkeypatch):
    """The reference replica on a (1, 1) Auto-axis mesh, as
    ``tests/test_torch_serve.py`` builds it (ROADMAP Queue C, R3), and its
    weights as the reference's checkpoint leaves."""
    import jax
    from jax.sharding import AxisType

    import repro.parallel.moe_parallel as jmp
    from repro.checkpoint.manager import _flatten
    from repro.configs import get_smoke_config
    from repro.launch.serve import ServeReplica
    from repro.models.model import Model
    from repro.runtime.fabric import Request
    from repro_torch.launch import serve

    if "check_rep" not in inspect.signature(jmp.shard_map).parameters:
        def shim(f, **kw):
            kw["check_vma"] = kw.pop("check_rep")
            return jax.shard_map(f, **kw)

        monkeypatch.setattr(jmp, "shard_map", shim)
    cfg = dataclasses.replace(get_smoke_config(ARCH), decode_plane=True, spec_tokens=Tn)
    params = Model(cfg).init(jax.random.PRNGKey(0))
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    rep = ServeReplica(cfg, mesh, SLOTS, PROMPT + GEN + Tn, params, drafter="ngram")
    queue, out = list(serve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, N_REQ)), {}
    while queue or rep.has_work():
        while queue and rep.free_slots():
            r = queue.pop(0)
            rep.admit(Request(rid=r.rid, prompt=r.prompt, gen=r.gen))
        for res in rep.step():
            out[str(res.rid)] = list(map(int, res.tokens))
    names, leaves, _ = _flatten(params)
    return out, {n: np.asarray(v) for n, v in zip(names, leaves)}


def test_mesh_replica_streams_match_reference_on_every_rank(tmp_path, monkeypatch):
    want = {}
    for Tn in (1, 4):
        want[str(Tn)], arrays = _reference_streams(Tn, monkeypatch)
        np.savez(tmp_path / f"weights{Tn}.npz", **arrays)
        assert len(want[str(Tn)]) == N_REQ and all(len(t) == GEN + 1 for t in want[str(Tn)].values())
    run_ranks(_serve_worker, 2, tmp_path)
    for rank in range(2):
        assert json.loads((tmp_path / f"streams{rank}.json").read_text()) == want, f"rank {rank}"


def _cli(args, tmp_path, launcher=()):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    cmd = [sys.executable, *launcher, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
           "--decode-plane", "--slots", "2", "--prompt-len", "16", "--gen", "8", "--device", "cpu", *args]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)


@pytest.mark.parametrize("plane", [
    ["--spec-tokens", "4"],
    # the paged plane with a draft tree, the model drafter and a shared prefix
    ["--paged", "--page-size", "8", "--draft-tree", "2,1", "--drafter", "model", "--shared-prefix", "16",
     "--expect-shared-pages"],
])
def test_cli_model_2_under_torchrun_serves_the_single_rank_streams(plane, tmp_path):
    two = _cli(plane + ["--model", "2", "--dump-tokens", str(tmp_path / "two.json")], tmp_path,
               ("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"))
    assert two.returncode == 0, two.stderr[-3000:]
    assert two.stdout.count("served 4 requests") == 1  # rank 0 alone prints
    assert "'model': 2" in two.stdout
    one = _cli(plane + ["--dump-tokens", str(tmp_path / "one.json")], tmp_path)
    assert one.returncode == 0, one.stderr[-3000:]
    streams = json.loads((tmp_path / "two.json").read_text())
    assert sorted(streams) == ["0", "1", "2", "3"] and all(len(s) == 9 for s in streams.values())
    assert streams == json.loads((tmp_path / "one.json").read_text())


@pytest.mark.parametrize("args,msg", [(["--data", "2"], "torchrun"), (["--model", "2"], "torchrun")])
def test_cli_refuses_data_axis_and_model_axis_without_a_launcher(args, msg, monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as exit_:
        serve.main(["--arch", ARCH, "--smoke", "--decode-plane", "--device", "cpu", *args])
    assert exit_.value.code == 2
    assert msg in capsys.readouterr().err
