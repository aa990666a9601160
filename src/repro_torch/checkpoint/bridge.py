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

:func:`leaves_from_params` is the inverse: the port's params as the
reference's named leaves, re-stacked on the super-block axis, in the order
the reference's tree flattens them.  A bf16 leaf is stored as the
reference's ``np.save`` of a bf16 array stores it: the ``.npy`` header's
type ``<V2`` (two raw bytes) with the manifest's ``"dtype": "bfloat16"``;
:func:`read_leaf` reads such a leaf back as bf16 bits, never through f32 and
without ``ml_dtypes``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, storage_dtype
from repro_torch.models.transformer import place_tied_unembed
from repro_torch.parallel.sharding import expert_slice, is_expert_stack

Leaf = Union[np.ndarray, torch.Tensor]  # a bf16 leaf is a CPU bf16 tensor


def _put(tree: dict, path, arr: Leaf, cfg: ModelConfig, device, mesh) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    dt = storage_dtype(cfg, path[-1])
    sl = expert_slice(cfg, mesh)
    if sl is not None and is_expert_stack(path, arr.shape):
        arr = arr[sl]  # the rank's expert slice, cut before the copy
    if isinstance(arr, torch.Tensor):  # bf16 bits (read_leaf), never widened on the host
        tree[path[-1]] = arr.to(device=device, dtype=dt, copy=True)
    elif arr.dtype.kind == "V":
        raise ValueError(f"leaf {'/'.join(path)} holds raw {arr.dtype.itemsize}-byte elements: "
                         "read it with read_leaf, which needs the manifest's dtype")
    elif dt == torch.int8:  # the reference's int8 twins, bit for bit (never re-quantized)
        tree[path[-1]] = torch.from_numpy(np.array(arr, dtype=np.int8)).to(device)
    else:
        tree[path[-1]] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dt)


def params_from_numpy(cfg: ModelConfig, arrays: Dict[str, Leaf], device, mesh=None) -> Params:
    """{leaf name: array} as the reference writes them -> port params (this
    rank's expert slice when ``mesh`` has a ``model`` axis of more than one
    rank).  A bf16 leaf may come as a CPU bf16 tensor (:func:`read_leaf`)."""
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


def read_leaf(path, dtype: str) -> Leaf:
    """One ``.npy`` leaf whose manifest type is ``dtype``: a numpy array, or
    for ``"bfloat16"`` (stored as ``<V2``) a CPU bf16 tensor over the same
    bytes."""
    arr = np.load(path)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        if dtype != "bfloat16":
            raise ValueError(f"{Path(path).name}: 2-byte raw elements, but the manifest says {dtype!r}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def load_step_dir(cfg: ModelConfig, step_dir, device, mesh=None) -> Params:
    """Params of a ``CheckpointManager`` step directory, the reference's or
    the port's (``manifest.json`` plus one ``.npy`` file per leaf); needs no
    jax and no ``ml_dtypes``."""
    step_dir = Path(step_dir)
    with open(step_dir / "manifest.json") as f:
        manifest = json.load(f)
    arrays = {rec["name"]: read_leaf(step_dir / rec["file"], rec["dtype"]) for rec in manifest["params"]}
    return params_from_numpy(cfg, arrays, device, mesh)


def _tensor_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    out = []
    for key, value in tree.items():
        if isinstance(value, torch.Tensor):
            out.append((prefix + (key,), value))
        else:
            out.extend(_tensor_paths(value, prefix + (key,)))
    return out


def leaf_order(name: str):
    """Sort key of a leaf name in the reference's flatten order: dict keys
    sorted at every level, list entries (``blocks/rest/{i}``) by index."""
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c) for c in name.split("/"))


def leaves_from_params(cfg: ModelConfig, params: Params) -> List[Tuple[str, Callable[[], torch.Tensor]]]:
    """The inverse of :func:`params_from_numpy`: ``(reference leaf name,
    thunk)`` pairs in the reference's flatten order, each thunk giving the
    leaf as a CPU tensor in its stored type (``scan`` leaves re-stacked on
    the super-block axis; no ``unembed`` under tied embeddings).  Leaves
    are made one at a time, so a writer holds one on the host at once.
    Raises on a rank's expert slice: a checkpoint holds every expert."""
    pat = cfg.block_pattern
    n_sb = cfg.num_layers // len(pat)
    layers = params["layers"]
    for layer in layers:
        for path, t in _tensor_paths(layer):
            if is_expert_stack(path, tuple(t.shape)) and t.shape[0] != cfg.num_experts:
                raise ValueError(f"{'/'.join(path)} holds {t.shape[0]} of {cfg.num_experts} experts: "
                                 "a checkpoint holds the full stacks, not a rank's slice")
    out: List[Tuple[str, Callable[[], torch.Tensor]]] = []
    for path, t in _tensor_paths({k: v for k, v in params.items() if k != "layers"}):
        if path == ("unembed",) and cfg.tie_embeddings:
            continue  # made from embed when the weights are placed
        out.append(("/".join(path), lambda t=t: t.cpu()))

    def stacked(j, path, like):
        def make():
            host = torch.empty((n_sb, *like.shape), dtype=like.dtype)
            for s in range(n_sb):
                leaf = layers[s * len(pat) + j]
                for key in path:
                    leaf = leaf[key]
                host[s].copy_(leaf)
            return host
        return make

    for j in range(len(pat) if n_sb else 0):
        for path, t in _tensor_paths(layers[j]):
            out.append(("/".join(("blocks", "scan", f"b{j}") + path), stacked(j, path, t)))
    for i, layer in enumerate(layers[n_sb * len(pat):]):
        for path, t in _tensor_paths(layer):
            out.append(("/".join(("blocks", "rest", str(i)) + path), lambda t=t: t.cpu()))
    return sorted(out, key=lambda item: leaf_order(item[0]))

