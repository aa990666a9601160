"""PyTorch port, the serve fabric's checkpoints of expert slices and its
elastic re-shard, on spawned gloo CPU ranks (Qwen3-MoE smoke, decode plane,
spec 2).

* A sharded save (``CheckpointManager.save(..., mesh=)``) at (2, 2), every
  rank holding its ``model`` slice of the experts, writes the files of a
  one-rank save of the same weights, bitwise, leaf by leaf; a second save
  of the unchanged shares links them (no byte written); ``restore(mesh=)``
  gives each rank its slice back.
* The reference's ``test_fabric_crash_reshard_8dev_byte_identical`` at
  (2, 2): a crash flagged ``shrink=1`` with a checkpoint every 2 rounds
  rebuilds the replica through ``reshard_serve_after_failure`` on the
  survivors' (1, 2) mesh (``shrink_to=(2, 2)``): ranks 0 and 1 emit the
  clean run's streams byte for byte, with crashes 1, rejoins 1, restores
  >= 1, re-warm prefills >= 1, dropped 0, duplicates 0; ranks 2 and 3
  leave the mesh (``LeftMesh``) and exit 0.
* The serve CLI under ``torchrun``: ``--model 2 --inject crash@step=3
  --checkpoint-every 2``, and ``--data 2 --model 2`` with
  ``crash@step=3:shrink=1``, exit 0 with the clean ``--model 1`` streams.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_expert_parallel import run_ranks

ARCH = "qwen3-moe-235b-a22b"
GEN, T, SLOTS, N_REQ, PROMPT = 4, 2, 2, 3, 6
REPO = Path(__file__).resolve().parent.parent


def _cfg():
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(ARCH), decode_plane=True, spec_tokens=T)


def _requests(vocab):
    from repro_torch.runtime.fabric import Request

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=PROMPT).astype(np.int32) for _ in range(N_REQ)]
    return [Request(rid=i, prompt=prompts[i], gen=GEN) for i in range(N_REQ)]


def _run(cfg, mesh, params, specs, ckpt, checkpoint_every):
    from repro_torch.launch import serve
    from repro_torch.runtime.fabric import FabricConfig, ServeFabric
    from repro_torch.runtime.faults import FaultInjector, parse_faults

    inj = FaultInjector(parse_faults(specs)) if specs else None
    ladder = serve.degrade_ladder(None, T)
    make = serve.make_replica_factory(cfg, SLOTS, PROMPT + GEN + T, params, ladder,
                                      fault_hook=inj.check if inj else None, launch_timeout=30.0, mesh=mesh,
                                      ckpt=ckpt, shrink_to=(2, 2))
    fabric = ServeFabric(
        make, _requests(cfg.vocab_size),
        FabricConfig(n_replicas=1, launch_timeout=30.0, checkpoint_every=checkpoint_every,
                     max_degrade_level=len(ladder) - 1, synthetic_step_times=True),
        ckpt=ckpt, restore_params=(lambda mgr: mgr.restore("cpu", mesh=mesh)[0]) if ckpt else None, params=params)
    results = fabric.run()
    return {str(rid): r.tokens for rid, r in results.items()}, fabric


def _rank(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager, params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.elastic import LeftMesh

    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous'}", rank=rank, world_size=world)
    out = {}
    try:
        mesh = make_host_mesh(2, 2, "cpu")
        cfg = _cfg()
        params = params_from_numpy(cfg, dict(np.load(d / "weights.npz")), "cpu", mesh)
        # the sharded save, a linked second save, the restore of the rank's slice
        ck = CheckpointManager(d / "sharded", keep=2, cfg=cfg)
        ck.save(1, params, {}, mesh=mesh)
        ck.save(2, params, {}, mesh=mesh)
        back = ck.restore("cpu", mesh=mesh)[0]
        out["restored_equal"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(back)))
        out["saves"] = [list(s) for s in ck.saves]
        out["experts_held"] = int(params["layers"][0]["moe"]["w_gate"].shape[0])
        # the clean run on (2, 2), then the shrink crash
        out["clean"], _ = _run(cfg, mesh, params, "", None, 0)
        ckpt = CheckpointManager(d / "fabric", keep=2, cfg=cfg)
        try:
            out["faulted"], fabric = _run(cfg, mesh, params, "crash@step=3:shrink=1", ckpt, 2)
        except LeftMesh:
            out["left"] = True
        else:
            out["stats"] = {k: fabric.stats[k] for k in ("crashes", "rejoins", "restores", "rewarm_prefills",
                                                          "dropped", "duplicates", "checkpoints")}
            out["mesh_after"] = fabric.mesh.shape
            out["world_after"] = dist.get_world_size()
        (d / f"out{rank}.json").write_text(json.dumps(out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.checkpoint.bridge import leaves_from_params
    from repro_torch.models.model import Model

    d = tmp_path_factory.mktemp("serve_elastic")
    cfg = _cfg()
    params = Model(cfg, "cpu").init(0)
    np.savez(d / "weights.npz", **{n: make().numpy() for n, make in leaves_from_params(cfg, params)})
    run_ranks(_rank, 4, d, timeout=240)
    return d, params, [json.loads((d / f"out{r}.json").read_text()) for r in range(4)]


def test_sharded_save_writes_the_one_rank_files_bitwise(ranks, tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    d, params, outs = ranks
    one = CheckpointManager(tmp_path / "one", cfg=_cfg())
    one.save(1, params, {})
    want = json.loads((tmp_path / "one" / "step_00000001" / "manifest.json").read_text())
    got = json.loads((d / "sharded" / "step_00000001" / "manifest.json").read_text())
    assert [(r["name"], r["shape"], r["dtype"]) for r in got["params"]] == \
        [(r["name"], r["shape"], r["dtype"]) for r in want["params"]]
    for g, w in zip(got["params"], want["params"]):
        a = (d / "sharded" / "step_00000001" / g["file"]).read_bytes()
        b = (tmp_path / "one" / "step_00000001" / w["file"]).read_bytes()
        assert a == b, g["name"]
    assert all(o["experts_held"] == _cfg().num_experts // 2 for o in outs)
    assert all(o["restored_equal"] for o in outs)
    lead = outs[0]["saves"]
    assert len(lead) == 2 and lead[0][3] > 0 and lead[1][3] == 0  # the second save links every file


def test_shrink_crash_reshards_onto_the_survivors_byte_identical(ranks):
    _, _, outs = ranks
    for rank in (0, 1):
        o = outs[rank]
        assert len(o["clean"]) == N_REQ and o["faulted"] == o["clean"], rank
        st = o["stats"]
        assert st["crashes"] == 1 and st["rejoins"] == 1, st
        assert st["restores"] >= 1 and st["rewarm_prefills"] >= 1, st
        assert st["dropped"] == 0 and st["duplicates"] == 0, st
        assert o["mesh_after"] == {"data": 1, "model": 2} and o["world_after"] == 2
    for rank in (2, 3):
        assert outs[rank].get("left") and outs[rank]["clean"] == outs[0]["clean"], rank


def _cli(args, cwd, launcher=()):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    cmd = [sys.executable, *launcher, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
           "--decode-plane", "--spec-tokens", "3", "--slots", "2", "--prompt-len", "16", "--gen", "12",
           "--device", "cpu", *args]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=180, env=env, cwd=cwd)


@pytest.mark.parametrize("mesh,faults", [
    (["--model", "2"], "crash@step=3"),
    (["--data", "2", "--model", "2"], "crash@step=3:shrink=1"),
])
def test_cli_with_faults_under_torchrun_serves_the_clean_streams(mesh, faults, tmp_path):
    n = 2 if "--data" not in mesh else 4
    run = _cli(mesh + ["--inject", faults, "--checkpoint-every", "2", "--dump-tokens", str(tmp_path / "f.json")],
               tmp_path, ("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(n)))
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("fabric: 1 crashes, 1 rejoins") == 1
    clean = _cli(["--dump-tokens", str(tmp_path / "c.json")], tmp_path)
    assert clean.returncode == 0, clean.stderr[-3000:]
    streams = json.loads((tmp_path / "f.json").read_text())
    assert len(streams) == 4 and streams == json.loads((tmp_path / "c.json").read_text())
