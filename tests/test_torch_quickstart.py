"""PyTorch port, ``examples/quickstart_torch.py`` on the CPU at tiny widths:
it trains through the port's ``Trainer`` with checkpoints, the loss falls,
and a rerun resumes from the last checkpoint.  Imports no jax.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

QUICKSTART = Path(__file__).resolve().parents[1] / "examples" / "quickstart_torch.py"


def _quickstart():
    spec = importlib.util.spec_from_file_location("quickstart_torch", QUICKSTART)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_on_cpu_and_the_loss_falls(tmp_path, capsys):
    """100 steps (the schedule's warm-up is 100 steps): the mean of the last
    five cross-entropies at least 0.5 below the first five's, and below the
    unigram floor log V."""
    qs = _quickstart()
    args = ["--device", "cpu", "--steps", "100", "--d-model", "64", "--layers", "2", "--seq-len", "64",
            "--batch", "8", "--ckpt", str(tmp_path)]
    out = qs.main(args)
    ce = [m["ce"] for m in out["metrics"]]
    assert out["final_step"] == 100 and out["restarts"] == 0 and len(ce) == 100
    assert all(np.isfinite(ce))
    assert np.mean(ce[-5:]) < np.mean(ce[:5]) - 0.5, (ce[:5], ce[-5:])
    assert ce[-1] < np.log(4096)
    text = capsys.readouterr().out
    assert "model: quickstart-lm" in text and "device=cpu" in text and "done: step=100" in text
    assert sorted(p.name for p in tmp_path.iterdir())  # checkpoints written
    again = qs.main(args)  # resumes at step 100: nothing to run
    assert again["final_step"] == 100 and again["final_loss"] is None
    assert "final loss=none" in capsys.readouterr().out
