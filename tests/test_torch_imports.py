"""PyTorch port, boundaries: the port imports neither jax nor the JAX
package, and its entry points refuse to fall back to the CPU silently."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_BLOCKER = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names), "modules")
"""


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[0]) >= 20


def test_entry_points_without_a_card_raise(monkeypatch):
    """No GPU and no explicit CPU request: an error, never a silent CPU run."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), decode_plane=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ServeReplica(cfg, 1, 16, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-moe-235b-a22b", "--smoke"])
    assert Model(cfg, device="cpu").device.type == "cpu"
