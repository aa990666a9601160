"""Checkpoints in the reference's on-disk format: one ``.npy`` file per leaf
plus ``manifest.json``, atomic commit, old-step GC, torn-step fallback (the
port's counterpart of ``repro/checkpoint/manager.py``).

A step is written into ``<dir>/tmp.step_N``, its manifest fsynced, then
renamed to ``<dir>/step_N``: a crash mid-write never corrupts the latest
restorable step.  ``keep`` committed steps survive each save.  ``restore``
takes the newest committed step that loads; a step whose manifest or a leaf
file is unreadable or truncated (:class:`TornCheckpointError`) falls back
to the next-newest one.

The port's params are written under the reference's leaf names
(:func:`repro_torch.checkpoint.bridge.leaves_from_params`: per-layer dicts
re-stacked on the super-block axis, in the reference's flatten order, no
``unembed`` leaf under tied embeddings, int8 twins and their scales bit for
bit) and read back through the bridge (:func:`bridge.load_step_dir`), so a
step directory crosses between the two packages both ways.  bf16 leaves are
stored as the reference stores them (``<V2``, manifest dtype
``"bfloat16"``) and read back as bf16 bits.  ``opt_state`` and any params
that are not the port's model tree are nested dicts of arrays, flattened by
sorted key.

Weights that never change (a serving fabric checkpoints the same params
every few rounds) are written once: when every tensor of ``params`` is the
one the previous save wrote, unwritten since (the same object, storage and
version counter, which torch bumps on every in-place write), the new step
hard-links the previous step's leaf files instead of writing them again.
A step directory stays complete on its own; GC of the older step leaves
the newer one's links intact.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.bridge import leaf_order, leaves_from_params, params_from_numpy, read_leaf


class TornCheckpointError(Exception):
    """A committed step directory is unreadable or truncated (crash damage)."""


def _jsonify(obj: Any) -> Any:
    """Coerce numpy scalars and arrays in ``extra`` to plain JSON values
    (serve ledgers are built from numpy slot state)."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _jsonify(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _flat(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs of a nested dict of arrays, keys sorted."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree, key=str):
        out.extend(_flat(tree[key], f"{prefix}/{key}" if prefix else str(key)))
    return out


def write_leaf(path: Path, leaf) -> Tuple[List[int], str, int]:
    """Write one leaf as ``.npy``; returns (shape, manifest dtype, bytes).
    bf16 goes out as its raw bits under the header type ``<V2``, as numpy
    writes a bf16 array."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            bits = leaf.contiguous().view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False, "shape": tuple(bits.shape)})
                bits.tofile(f)
            return list(bits.shape), "bfloat16", bits.nbytes
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype), arr.nbytes


def _tensors(tree: Any) -> Optional[List[torch.Tensor]]:
    """Every leaf of a nested dict / list of tensors, in a fixed order;
    None if a leaf is not a tensor."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = [tree[k] for k in sorted(tree, key=str)] if isinstance(tree, dict) else tree
    if not isinstance(items, (list, tuple)):
        return None
    out: List[torch.Tensor] = []
    for item in items:
        sub = _tensors(item)
        if sub is None:
            return None
        out.extend(sub)
    return out


def _identity(tree: Any) -> Optional[Tuple[list, tuple]]:
    """(weak references, key) of a tree of tensors: each leaf's object,
    storage, version counter, shape and type.  An equal key while every
    reference is alive means no leaf was replaced or written in place since.
    None when a leaf is not a tensor or keeps no version counter (an
    inference tensor)."""
    leaves = _tensors(tree)
    if not leaves:
        return None
    try:
        key = tuple((id(t), t.data_ptr(), t._version, tuple(t.shape), t.dtype, str(t.device)) for t in leaves)
    except RuntimeError:
        return None
    return [weakref.ref(t) for t in leaves], key


class CheckpointManager:
    """``cfg`` (a :class:`repro_torch.configs.ModelConfig`) names the model
    whose params :meth:`save` writes and :meth:`restore` places; without it
    params are plain nested dicts of arrays.  ``saves`` logs each call's
    (step, seconds, bytes, bytes written: 0 for linked params),
    ``restores`` each call's (step, seconds, bytes)."""

    def __init__(self, directory, *, keep: int = 3, cfg=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.cfg = cfg
        self.saves: List[Tuple[int, float, int, int]] = []
        self.restores: List[Tuple[int, float, int]] = []
        # the last model-params save: (step, weak references, key, manifest records, bytes)
        self._last: Optional[Tuple[int, list, tuple, List[dict], int]] = None

    # ------------------------------------------------------------------
    def _write_tree(self, step_dir: Path, tree: Any, prefix: str, model: bool) -> Tuple[List[dict], int]:
        if model:
            items = leaves_from_params(self.cfg, tree)
        else:
            items = [(n, (lambda v=v: v)) for n, v in sorted(_flat(tree), key=lambda nv: leaf_order(nv[0]))] \
                if tree else []
        files, total = [], 0
        for i, (name, make) in enumerate(items):
            fn = f"{prefix}.{i:05d}.npy"
            shape, dtype, nbytes = write_leaf(step_dir / fn, make())
            files.append({"name": name, "file": fn, "shape": shape, "dtype": dtype})
            total += nbytes
        return files, total

    def save(self, step: int, params: Any, opt_state: Any = None, extra: Optional[Dict] = None) -> Path:
        t0 = time.perf_counter()
        self._gc_tmp()
        tmp = self.dir / f"tmp.step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        model = isinstance(params, dict) and "layers" in params
        if model and self.cfg is None:
            raise ValueError("saving a model's params needs the manager's cfg")
        ident = _identity(params) if model else None
        files_p = self._link_unchanged(tmp, ident)
        if files_p is not None:
            nbytes, written = self._last[4], 0
        else:
            files_p, nbytes = self._write_tree(tmp, params, "params", model)
            written = nbytes
        files_o, nbytes_o = self._write_tree(tmp, opt_state or {}, "opt", False)
        manifest = {"step": step, "params": files_p, "opt_state": files_o, "extra": _jsonify(extra or {})}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self.dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._last = (step, ident[0], ident[1], files_p, nbytes) if ident is not None else None
        self._gc()
        self.saves.append((step, time.perf_counter() - t0, nbytes + nbytes_o, written + nbytes_o))
        return final

    def _link_unchanged(self, tmp: Path, ident) -> Optional[List[dict]]:
        """Hard-link the previous save's param files into ``tmp`` when
        ``ident`` shows the same tensors, unwritten since; their manifest
        records, or None (nothing linked) to write them anew."""
        if ident is None or self._last is None:
            return None
        step, refs, key, files, _ = self._last
        prev = self.dir / f"step_{step:08d}"
        if key != ident[1] or any(r() is None for r in refs) or not (prev / "manifest.json").exists():
            return None
        try:
            for rec in files:
                os.link(prev / rec["file"], tmp / rec["file"])
        except OSError:
            for p in tmp.glob("params.*.npy"):
                p.unlink()
            return None
        return files

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def _gc_tmp(self) -> None:
        """Remove ``tmp.step_*`` leftovers of interrupted saves (saves are
        single-writer, so any present when a save begins is dead)."""
        for p in self.dir.glob("tmp.step_*"):
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if (p / "manifest.json").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read(self, d: Path, files: List[dict]) -> Dict[str, Any]:
        out = {}
        for rec in files:
            try:
                out[rec["name"]] = read_leaf(d / rec["file"], rec["dtype"])
            except (OSError, EOFError, ValueError) as err:
                # a missing or truncated leaf file: torn data, not a caller error
                raise TornCheckpointError(f"checkpoint leaf {rec.get('name', rec.get('file'))} unreadable: "
                                          f"{err}") from err
            if tuple(out[rec["name"]].shape) != tuple(rec["shape"]):
                raise TornCheckpointError(f"checkpoint leaf {rec['name']} has shape "
                                          f"{tuple(out[rec['name']].shape)}, the manifest {tuple(rec['shape'])}")
        return out

    def _restore_step(self, step: int, device, mesh) -> Tuple[Any, Dict[str, Any], int, Dict]:
        t0 = time.perf_counter()
        d = self.dir / f"step_{step:08d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            files_p, files_o = manifest["params"], manifest["opt_state"]
        except (OSError, json.JSONDecodeError, KeyError, TypeError) as err:
            raise TornCheckpointError(f"manifest for step {step} unreadable: {err}") from err
        arrays = self._read(d, files_p)
        opt = self._read(d, files_o)
        nbytes = sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes
                     for a in list(arrays.values()) + list(opt.values()))
        params = params_from_numpy(self.cfg, arrays, device, mesh) if self.cfg is not None and arrays else arrays
        if isinstance(device, torch.device) and device.type == "cuda":
            torch.cuda.synchronize(device)
        self.restores.append((manifest["step"], time.perf_counter() - t0, nbytes))
        return params, opt, manifest["step"], manifest.get("extra", {})

    def restore(self, device=None, *, step: Optional[int] = None, mesh=None) -> Tuple[Any, Dict[str, Any], int, Dict]:
        """(params, opt_state leaves by name, step, extra) of ``step``, or of
        the newest committed step that loads.  With ``cfg`` the params are
        placed on ``device`` (this rank's expert slice under ``mesh``;
        ``None`` means the card, :func:`repro_torch.resolve_device`)."""
        device = resolve_device(device) if self.cfg is not None else device
        if step is not None:
            # an explicit step stays strict: the caller asked for THIS snapshot
            return self._restore_step(step, device, mesh)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        torn: List[Tuple[int, str]] = []
        for s in reversed(steps):
            try:
                return self._restore_step(s, device, mesh)
            except TornCheckpointError as err:
                # crash-damaged snapshot: remember why and fall back to the
                # next-newest complete step
                torn.append((s, str(err)))
        raise FileNotFoundError(f"no restorable checkpoint in {self.dir}; all committed steps torn: {torn}")
