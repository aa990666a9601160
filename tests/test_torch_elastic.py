"""PyTorch port, the elastic path and the sharded train CLI, on gloo CPU
ranks (spawned; rendezvous through a file, or torchrun's on localhost).

* The Trainer on a (2, 2) mesh (StarCoder2 smoke, ``tp``, 4 steps,
  checkpoints every 2, a failure injected at step 3): one restart, the
  replayed step's loss equal to its first run's; then 2 survivors rebuild a
  (1, 2) mesh with ``runtime.elastic.reshard_after_failure``: the restored
  step is 4 and the gathered params are bitwise the checkpoint's (which the
  one-rank port restores too); the next step's loss equals the JAX
  reference's ``reshard_after_failure`` on an Auto-axis (1, 2) host mesh
  restoring the same directory within 1e-5 relative.
* ``launch/train.py --data 2 --model 2 --device cpu`` under torchrun trains
  Qwen3-MoE smoke with ``--strategy tp`` and StarCoder2 smoke with
  ``fsdp``; a world size that is not ``--data x --model`` exits 2.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from test_torch_expert_parallel import run_ranks

REPO = Path(__file__).resolve().parent.parent
ARCH, B, S = "starcoder2-3b", 4, 16


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(9).integers(0, vocab, (B, S)).astype(np.int32)


def _train_worker(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous4'}", rank=rank, world_size=world)
    try:
        tr = Trainer(get_smoke_config(ARCH), ShapeCell("t", S, B, "train"), make_host_mesh(2, 2, "cpu"),
                     TrainerConfig(num_steps=4, checkpoint_every=2, checkpoint_dir=str(d / "ckpt"), log_every=100),
                     failure_injector=FailureInjector([3]))
        out = tr.run()
        if rank == 0:
            (d / "trainer.json").write_text(json.dumps({"final_step": out["final_step"], "restarts": out["restarts"],
                                                        "losses": [(m["step"], m["loss"]) for m in out["metrics"]]}))
    finally:
        dist.destroy_process_group()


def _survivor_worker(rank: int, world: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.bridge import leaves_from_params
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.parallel.sharding import gather_leaf, map_specs
    from repro_torch.runtime.elastic import reshard_after_failure

    torch.set_num_threads(1)
    d = Path(d)
    dist.init_process_group("gloo", init_method=f"file://{d / 'rendezvous2'}", rank=rank, world_size=world)
    try:
        cfg = get_smoke_config(ARCH)
        st = reshard_after_failure(cfg, ShapeCell("t", S, B, "train"), CheckpointManager(d / "ckpt", cfg=cfg, train=True),
                                   n_healthy=2, model_axis=2, device="cpu")
        full = map_specs(lambda t, s: gather_leaf(t, s, st.mesh), st.params, st.step_fn.specs)
        out = {n: make().numpy().copy() for n, make in leaves_from_params(cfg, full)}
        _, _, _, m = st.step_fn(st.params, st.opt_state, st.step, torch.from_numpy(_tokens(cfg.vocab_size)))
        if rank == 0:
            np.savez(d / "survivor.npz", **out)
            (d / "survivor.json").write_text(json.dumps({"step": st.step, "mesh": st.mesh.shape,
                                                         "loss": float(m["loss"])}))
    finally:
        dist.destroy_process_group()


_REFERENCE = textwrap.dedent('''
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.checkpoint import CheckpointManager
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeCell
    from repro.runtime.elastic import reshard_after_failure
    d = sys.argv[1]
    cfg = get_smoke_config("%s")
    st = reshard_after_failure(cfg, ShapeCell("t", %d, %d, "train"), CheckpointManager(d + "/ckpt"),
                               n_healthy=2, model_axis=2, devices=jax.devices()[:2])
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (%d, %d)).astype(np.int32)
    with st.mesh:
        _, _, _, m = st.step_fn(st.params, st.opt_state, jnp.int32(st.step), jnp.asarray(toks))
    print("STEP", st.step, "LOSS", float(m["loss"]))
''' % (ARCH, S, B, B, S))


def test_trainer_failure_then_reshard_onto_survivors_matches_reference(tmp_path):
    import torch

    from repro_torch.checkpoint.bridge import leaves_from_params
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config

    run_ranks(_train_worker, 4, tmp_path, timeout=180)
    log = json.loads((tmp_path / "trainer.json").read_text())
    assert log["final_step"] == 4 and log["restarts"] == 1
    steps = [s for s, _ in log["losses"]]
    assert steps == [1, 2, 3, 3, 4], steps
    assert abs(log["losses"][2][1] - log["losses"][3][1]) <= 1e-6 * abs(log["losses"][2][1]), "the replay"

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2", PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(tmp_path)], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env)
    try:
        run_ranks(_survivor_worker, 2, tmp_path, timeout=180)
        out, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    surv = json.loads((tmp_path / "survivor.json").read_text())
    assert surv["step"] == 4 and surv["mesh"] == {"data": 1, "model": 2}
    words = out.split()
    assert int(words[words.index("STEP") + 1]) == 4
    want = float(words[words.index("LOSS") + 1])
    assert abs(surv["loss"] - want) <= 1e-5 * abs(want), (surv["loss"], want)

    # the restored shards, gathered, are bitwise the checkpoint's leaves, as the one-rank port restores them
    cfg = get_smoke_config(ARCH)
    params, opt, step, _ = CheckpointManager(tmp_path / "ckpt", cfg=cfg, train=True).restore("cpu")
    assert step == 4 and set(opt) == {"m", "v"}
    got = dict(np.load(tmp_path / "survivor.npz"))
    names = [n for n, _ in leaves_from_params(cfg, params)]
    assert sorted(got) == sorted(names)
    for n, make in leaves_from_params(cfg, params):
        assert torch.equal(torch.from_numpy(got[n]), make()), n


@pytest.mark.parametrize("arch,strategy", [("qwen3-moe-235b-a22b", "tp"), ("starcoder2-3b", "fsdp")])
def test_train_cli_under_torchrun_trains_a_2x2_mesh(tmp_path, arch, strategy):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
           "-m", "repro_torch.launch.train", "--arch", arch, "--smoke", "--steps", "2", "--seq-len", str(S),
           "--batch", str(B), "--data", "2", "--model", "2", "--strategy", strategy, "--device", "cpu",
           "--ckpt", str(tmp_path / "ckpt"), "--checkpoint-every", "2"]
    run = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=240)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("finished: step 2, loss ") == 1, run.stdout  # rank 0 reports
    assert (tmp_path / "ckpt" / "step_00000002" / "manifest.json").exists()


def test_train_cli_refuses_a_world_that_is_not_the_mesh(monkeypatch, capsys, tmp_path):
    from repro_torch.launch import train

    monkeypatch.setenv("WORLD_SIZE", "2")  # as torchrun --nproc-per-node 2 would set it
    with pytest.raises(SystemExit) as exit_:
        train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--data", "2", "--model", "2",
                    "--ckpt", str(tmp_path)])
    assert exit_.value.code == 2
    assert "launch it with torchrun --nproc-per-node 4 (WORLD_SIZE is 2)" in capsys.readouterr().err
