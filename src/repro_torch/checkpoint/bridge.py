"""Load the reference's parameter leaves into the port's layout.

The reference names each leaf by its "/"-joined tree path
(``checkpoint/manager._flatten``): ``embed``, ``final_norm``, ``unembed``,
``blocks/scan/b{j}/<path>`` stacked on a leading super-block axis, and
``blocks/rest/{i}/<path>`` for a pattern-incomplete tail.  The port keeps one
dict per layer, so the super-block axis is un-stacked here: super-block
``s``, pattern slot ``j`` is layer ``s * len(pattern) + j``, and the
tail's ``blocks/rest/{i}`` is layer ``n_superblocks * len(pattern) + i``
(RecurrentGemma-2B: 26 layers over ``rec, rec, attn`` are 8 super-blocks
and two ``rec`` layers; Mamba-2-2.7B: 64 super-blocks of the pattern
``ssm``, each leaf ``blocks/scan/b0/ssm/<name>`` or ``blocks/scan/b0/ln1``:
an ``ssm`` layer has one pre-norm and no ``ln2``).  Each leaf is stored in
the type its use computes in (:func:`layers.storage_dtype`); the int8 expert
twins ``*_q`` stay int8 and their scales ``*_s`` f32, bit for bit.  Tied
embeddings have no ``unembed`` leaf: the f32 table the logits read is made
from ``embed`` here (:func:`transformer.place_tied_unembed`).  Given a
mesh, each rank places only its slice of the expert stacks, their int8
twins and scales (the layout of
:func:`repro_torch.parallel.sharding.shard_params`), cut from the arrays
before they are copied.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, storage_dtype
from repro_torch.models.transformer import place_tied_unembed
from repro_torch.parallel.sharding import expert_slice, is_expert_stack


def _put(tree: dict, path, arr: np.ndarray, cfg: ModelConfig, device, mesh) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    dt = storage_dtype(cfg, path[-1])
    sl = expert_slice(cfg, mesh)
    if sl is not None and is_expert_stack(path, arr.shape):
        arr = arr[sl]  # the rank's expert slice, cut before the copy
    if dt == torch.int8:  # the reference's int8 twins, bit for bit (never re-quantized)
        tree[path[-1]] = torch.from_numpy(np.array(arr, dtype=np.int8)).to(device)
    else:
        tree[path[-1]] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dt)


def params_from_numpy(cfg: ModelConfig, arrays: Dict[str, np.ndarray], device, mesh=None) -> Params:
    """{leaf name: array} as the reference writes them -> port params (this
    rank's expert slice when ``mesh`` has a ``model`` axis of more than one
    rank)."""
    pat = cfg.block_pattern
    n_sb = cfg.num_layers // len(pat)
    layers = [dict() for _ in range(cfg.num_layers)]
    params: Params = {"layers": layers}
    for name, arr in arrays.items():
        parts = name.split("/")
        if parts[0] != "blocks":
            _put(params, parts, arr, cfg, device, mesh)
        elif parts[1] == "scan":
            j = int(parts[2][1:])
            if arr.shape[0] != n_sb:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != {n_sb} super-blocks")
            for s in range(n_sb):
                _put(layers[s * len(pat) + j], parts[3:], arr[s], cfg, device, mesh)
        elif parts[1] == "rest":
            _put(layers[n_sb * len(pat) + int(parts[2])], parts[3:], arr, cfg, device, mesh)
        else:
            raise ValueError(f"unknown parameter leaf {name!r}")
    if any(not layer for layer in layers):
        raise ValueError("the leaves do not cover every layer of the config")
    return place_tied_unembed(params, cfg)


def load_step_dir(cfg: ModelConfig, step_dir, device) -> Params:
    """Params of a reference ``CheckpointManager`` step directory
    (``manifest.json`` plus one ``.npy`` file per leaf); needs no jax."""
    step_dir = Path(step_dir)
    with open(step_dir / "manifest.json") as f:
        manifest = json.load(f)
    arrays = {rec["name"]: np.load(step_dir / rec["file"]) for rec in manifest["params"]}
    return params_from_numpy(cfg, arrays, device)
