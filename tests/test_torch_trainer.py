"""PyTorch port, the fault-tolerant trainer against the reference's on the
CPU: StarCoder2-3B's smoke config, seq 32, batch 4, 10 steps,
checkpoints every 4, an injected failure at step 6 (restore step 4, seek
the stream, replay), as ``tests/test_runtime.py`` runs the reference's.

Gates: the replayed steps repeat their losses to 5 decimals; every
executed step's loss (replays included, in order) within 1e-5 relative of
the reference Trainer's on an Auto-axis (1, 1) mesh (caveat R2), both
started from the reference's initial weights; the port's step directory
holds the reference's leaf names (params, ``m/...``, ``v/...``)."""
from __future__ import annotations

import json

import jax
import pytest

from _torch_arch_cases import bridge, host_mesh
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeCell as JCell
from repro.models.model import Model as JModel
from repro.runtime import FailureInjector as JFailureInjector
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import ShapeCell
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

ARCH = "starcoder2-3b"
SEQ, BATCH, STEPS, EVERY, FAIL = 32, 4, 10, 4, 6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    arrays = bridge(JModel(j_smoke(ARCH)).init(jax.random.PRNGKey(0)))
    tcfg = t_smoke(ARCH)
    port_dir = tmp_path_factory.mktemp("port")
    port = Trainer(tcfg, ShapeCell("smoke", SEQ, BATCH, "train"), "cpu",
                   TrainerConfig(num_steps=STEPS, checkpoint_every=EVERY, checkpoint_dir=str(port_dir), log_every=100),
                   failure_injector=FailureInjector(fail_at=[FAIL]),
                   init_params=lambda: params_from_numpy(tcfg, arrays, "cpu", train=True)).run()
    ref_dir = tmp_path_factory.mktemp("ref")
    ref = JTrainer(j_smoke(ARCH), JCell("smoke", SEQ, BATCH, "train"), host_mesh(),
                   JTrainerConfig(num_steps=STEPS, checkpoint_every=EVERY, checkpoint_dir=str(ref_dir), log_every=100),
                   failure_injector=JFailureInjector(fail_at=[FAIL])).run()
    return port, ref, port_dir, ref_dir


def test_trainer_replays_an_injected_failure_to_five_decimals(runs):
    out = runs[0]
    assert out["final_step"] == STEPS and out["restarts"] == 1
    per_step = {}
    for m in out["metrics"]:
        per_step.setdefault(m["step"], []).append(m["loss"])
    replayed = {s: ls for s, ls in per_step.items() if len(ls) > 1}
    assert sorted(replayed) == [EVERY + 1, FAIL]  # steps 5 and 6 ran twice
    for s, ls in replayed.items():
        assert len({round(x, 5) for x in ls}) == 1, f"non-deterministic replay at {s}: {ls}"


def test_trainer_losses_match_the_reference_trainer(runs):
    port, ref = runs[0], runs[1]
    assert port["restarts"] == ref["restarts"] == 1
    got = [(m["step"], m["loss"]) for m in port["metrics"]]
    want = [(m["step"], m["loss"]) for m in ref["metrics"]]
    assert [s for s, _ in got] == [s for s, _ in want]
    for (s, a), (_, b) in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (s, a, b)
    assert set(m["grad_norm"] > 0 for m in port["metrics"]) == {True}


def test_trainer_checkpoints_hold_the_reference_leaf_names(runs):
    port_dir, ref_dir = runs[2], runs[3]
    names = []
    for d in (port_dir, ref_dir):
        man = json.loads((d / f"step_{STEPS:08d}" / "manifest.json").read_text())
        names.append((sorted(r["name"] for r in man["params"]), sorted(r["name"] for r in man["opt_state"])))
        assert man["step"] == STEPS
    assert names[0] == names[1]
    assert any(n.startswith("m/blocks/scan/b0/") for n in names[0][1])


def test_train_cli_resumes_from_its_checkpoint_directory(capsys, tmp_path):
    from repro_torch.launch import train

    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--seq-len", "16", "--batch", "2",
            "--checkpoint-every", "1", "--ckpt", str(tmp_path)]
    assert train.main(argv + ["--steps", "2"]) == 0
    assert "finished: step 2, loss " in capsys.readouterr().out
    # a rerun whose checkpoint is already at --steps runs nothing and says so
    assert train.main(argv + ["--steps", "2"]) == 0
    assert "finished: step 2, nothing to run" in capsys.readouterr().out
    # a longer run resumes at the checkpoint's step
    assert train.main(argv + ["--steps", "3"]) == 0
    assert "finished: step 3, loss " in capsys.readouterr().out
