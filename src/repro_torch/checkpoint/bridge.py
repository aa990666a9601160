"""Load the reference's parameter leaves into the port's layout.

The reference names each leaf by its "/"-joined tree path
(``checkpoint/manager._flatten``): ``embed``, ``final_norm``, ``unembed``,
``blocks/scan/b{j}/<path>`` stacked on a leading super-block axis, and
``blocks/rest/{i}/<path>`` for a pattern-incomplete tail.  The port keeps one
dict per layer, so the super-block axis is un-stacked here: super-block
``s``, pattern slot ``j`` is layer ``s * len(pattern) + j``.  Each leaf is
stored in the type its use computes in (:func:`layers.storage_dtype`).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, storage_dtype


def _put(tree: dict, path, arr: np.ndarray, cfg: ModelConfig, device) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    dt = storage_dtype(cfg, path[-1])
    tree[path[-1]] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dt)


def params_from_numpy(cfg: ModelConfig, arrays: Dict[str, np.ndarray], device) -> Params:
    """{leaf name: array} as the reference writes them -> port params."""
    pat = cfg.block_pattern
    n_sb = cfg.num_layers // len(pat)
    layers = [dict() for _ in range(cfg.num_layers)]
    params: Params = {"layers": layers}
    for name, arr in arrays.items():
        parts = name.split("/")
        if parts[0] != "blocks":
            _put(params, parts, arr, cfg, device)
        elif parts[1] == "scan":
            j = int(parts[2][1:])
            if arr.shape[0] != n_sb:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != {n_sb} super-blocks")
            for s in range(n_sb):
                _put(layers[s * len(pat) + j], parts[3:], arr[s], cfg, device)
        elif parts[1] == "rest":
            _put(layers[n_sb * len(pat) + int(parts[2])], parts[3:], arr, cfg, device)
        else:
            raise ValueError(f"unknown parameter leaf {name!r}")
    if any(not layer for layer in layers):
        raise ValueError("the leaves do not cover every layer of the config")
    return params


def load_step_dir(cfg: ModelConfig, step_dir, device) -> Params:
    """Params of a reference ``CheckpointManager`` step directory
    (``manifest.json`` plus one ``.npy`` file per leaf); needs no jax."""
    step_dir = Path(step_dir)
    with open(step_dir / "manifest.json") as f:
        manifest = json.load(f)
    arrays = {rec["name"]: np.load(step_dir / rec["file"]) for rec in manifest["params"]}
    return params_from_numpy(cfg, arrays, device)
