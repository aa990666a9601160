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
sorted key; a subtree in the model's layout inside them (AdamW's ``m`` and
``v``, Adafactor's whole state) is written under the reference's names
too (``m/blocks/scan/b0/attn/wq``), so a trainer's step directory holds
what the reference's holds.  A ``train`` manager places restored params
at ``cfg.param_dtype`` and rebuilds such an optimizer state
(:func:`bridge.tree_from_numpy`).

Weights that never change (a serving fabric checkpoints the same params
every few rounds) are written once: when every tensor of ``params`` is the
one the previous save wrote, unwritten since (the same object, storage and
version counter, which torch bumps on every in-place write), the new step
hard-links the previous step's leaf files instead of writing them again.
A step directory stays complete on its own; GC of the older step leaves
the newer one's links intact.

On a mesh (the sharded train step's ranks: ``save(..., mesh=, strategy=)``)
every leaf of params and optimizer state is gathered whole, leaf by leaf,
rank 0 writes the step as above while the other ranks wait at a barrier,
and ``restore(mesh=, strategy=)`` cuts each rank's shards of the new mesh
from the whole leaves: the files are the same at any mesh shape.  A
serving rank's params (``save(..., mesh=)`` without a strategy: the serve
placement, :func:`~repro_torch.parallel.sharding.serve_leaf_spec`) gather
their expert stacks whole the same way, unless no rank's shares changed
since its last save: then rank 0 hands the previous save's host tree to
:meth:`save` again, which links its files; ``restore(mesh=)`` cuts the
rank's expert slice.
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
from repro_torch.checkpoint.bridge import (
    leaf_order,
    leaves_from_params,
    params_from_numpy,
    read_leaf,
    tree_from_numpy,
)
from repro_torch.parallel.sharding import (
    gather_leaf,
    map_specs,
    opt_state_pspecs,
    param_pspecs,
    serve_shard_pspecs,
    shard_tree,
)


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
    params are plain nested dicts of arrays.  ``train`` restores the
    training layout: f32 master params and the optimizer state as trees.
    ``saves`` logs each call's (step, seconds, bytes, bytes written: 0 for
    linked params), ``restores`` each call's (step, seconds, bytes)."""

    def __init__(self, directory, *, keep: int = 3, cfg=None, train: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.cfg = cfg
        self.train = train
        self.saves: List[Tuple[int, float, int, int]] = []
        self.restores: List[Tuple[int, float, int]] = []
        # the last model-params save: (step, weak references, key, manifest records, bytes)
        self._last: Optional[Tuple[int, list, tuple, List[dict], int]] = None
        # the last serving save on a mesh: the rank's shares' identity and, on rank 0, the host tree written
        self._served: Optional[Tuple[list, tuple, Any]] = None

    # ------------------------------------------------------------------
    def _items(self, tree: Any) -> List[Tuple[str, Any]]:
        """(name, thunk) pairs of a nested dict of arrays (names joined by
        "/"); a subtree in the model's layout goes through
        :func:`leaves_from_params`."""
        if self.cfg is not None and isinstance(tree, dict) and "layers" in tree:
            return leaves_from_params(self.cfg, tree)
        if not isinstance(tree, dict):
            return [("", lambda v=tree: v)]
        return [(f"{key}/{name}" if name else str(key), make)
                for key in tree for name, make in self._items(tree[key])]

    def _write_tree(self, step_dir: Path, tree: Any, prefix: str, model: bool) -> Tuple[List[dict], int]:
        if model:
            items = leaves_from_params(self.cfg, tree)
        else:
            items = sorted(self._items(tree), key=lambda item: leaf_order(item[0])) if tree else []
        files, total = [], 0
        for i, (name, make) in enumerate(items):
            fn = f"{prefix}.{i:05d}.npy"
            shape, dtype, nbytes = write_leaf(step_dir / fn, make())
            files.append({"name": name, "file": fn, "shape": shape, "dtype": dtype})
            total += nbytes
        return files, total

    def _specs(self, opt_state: Any, mesh, strategy: str):
        from repro_torch.models.transformer import init_params

        shapes = init_params(self.cfg, None, "meta", train=True)  # the whole leaves' shapes
        specs = param_pspecs(shapes, mesh, strategy=strategy)
        return specs, (opt_state_pspecs(opt_state, shapes, mesh, strategy=strategy) if opt_state else None)

    def _save_sharded(self, step: int, params: Any, opt_state: Any, extra: Optional[Dict], mesh,
                      strategy: str) -> Path:
        import torch.distributed as dist

        p_specs, o_specs = self._specs(opt_state, mesh, strategy)
        lead = dist.get_rank() == 0

        def whole(shard, spec):  # every rank gathers; rank 0 keeps a host copy
            leaf = gather_leaf(shard, spec, mesh)
            return leaf.cpu() if lead else None

        full_p = map_specs(whole, params, p_specs)
        full_o = map_specs(whole, opt_state, o_specs) if opt_state else opt_state
        final = self.save(step, full_p, full_o, extra) if lead else self.dir / f"step_{step:08d}"
        dist.barrier()
        return final

    def _save_serve(self, step: int, params: Any, opt_state: Any, extra: Optional[Dict], mesh) -> Path:
        import torch.distributed as dist

        ident = _identity(params)
        same = (ident is not None and self._served is not None and self._served[1] == ident[1]
                and all(r() is not None for r in self._served[0]))
        flag = torch.tensor([int(same)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)  # every rank's shares unchanged, or all gather again
        lead = dist.get_rank() == 0
        if flag.item():
            whole = self._served[2]
        else:
            def gather(shard, spec):  # every rank gathers; rank 0 keeps a host copy
                leaf = gather_leaf(shard, spec, mesh)
                return leaf.cpu() if lead else None

            whole = map_specs(gather, params, serve_shard_pspecs(params, mesh))
            self._served = (ident[0], ident[1], whole if lead else None) if ident is not None else None
        final = self.save(step, whole, opt_state, extra) if lead else self.dir / f"step_{step:08d}"
        dist.barrier()
        return final

    def save(self, step: int, params: Any, opt_state: Any = None, extra: Optional[Dict] = None, *, mesh=None,
             strategy: Optional[str] = None) -> Path:
        """Write ``step`` atomically (module docstring).  With ``mesh`` and a
        training ``strategy`` ``params`` and ``opt_state`` are this rank's
        shards; with ``mesh`` alone ``params`` are a serving rank's (its
        expert slice, every other leaf whole).  Either way every rank of
        the mesh calls this and rank 0 writes the whole leaves."""
        if mesh is not None and strategy is not None:
            return self._save_sharded(step, params, opt_state, extra, mesh, strategy)
        if mesh is not None:
            return self._save_serve(step, params, opt_state, extra, mesh)
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
        # every leaf file is opened before any is read: a save running in
        # another process may GC this step's names meanwhile, never the data
        # of files already open
        handles = []
        try:
            for rec in files:
                try:
                    handles.append(open(d / rec["file"], "rb"))
                except OSError as err:
                    raise TornCheckpointError(f"checkpoint leaf {rec.get('name', rec.get('file'))} unreadable: "
                                              f"{err}") from err
            out = {}
            for rec, fh in zip(files, handles):
                try:
                    out[rec["name"]] = read_leaf(fh, rec["dtype"])
                except (OSError, EOFError, ValueError) as err:
                    # a truncated leaf file: torn data, not a caller error
                    raise TornCheckpointError(f"checkpoint leaf {rec.get('name', rec.get('file'))} unreadable: "
                                              f"{err}") from err
                if tuple(out[rec["name"]].shape) != tuple(rec["shape"]):
                    raise TornCheckpointError(f"checkpoint leaf {rec['name']} has shape "
                                              f"{tuple(out[rec['name']].shape)}, the manifest {tuple(rec['shape'])}")
            return out
        finally:
            for fh in handles:
                fh.close()

    def _restore_step(self, step: int, device, mesh, strategy=None) -> Tuple[Any, Dict[str, Any], int, Dict]:
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
        params = params_from_numpy(self.cfg, arrays, device, mesh, train=self.train, strategy=strategy) \
            if self.cfg is not None and arrays else arrays
        if self.train and opt:
            opt = tree_from_numpy(self.cfg, opt, device)
            if strategy is not None:
                opt = shard_tree(opt, self._specs(opt, mesh, strategy)[1], mesh)
        if isinstance(device, torch.device) and device.type == "cuda":
            torch.cuda.synchronize(device)
        self.restores.append((manifest["step"], time.perf_counter() - t0, nbytes))
        return params, opt, manifest["step"], manifest.get("extra", {})

    def restore(self, device=None, *, step: Optional[int] = None, mesh=None,
                strategy: Optional[str] = None) -> Tuple[Any, Dict[str, Any], int, Dict]:
        """(params, opt_state leaves by name, step, extra) of ``step``, or of
        the newest committed step that loads.  With ``cfg`` the params are
        placed on ``device`` (this rank's expert slice under ``mesh``;
        ``None`` means the card, :func:`repro_torch.resolve_device`); with
        ``mesh`` and a training ``strategy`` this rank's shards of the params
        and (a ``train`` manager's) optimizer state."""
        device = resolve_device(device) if self.cfg is not None else device
        if step is not None:
            # an explicit step stays strict: the caller asked for THIS snapshot
            return self._restore_step(step, device, mesh, strategy)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        torn: List[Tuple[int, str]] = []
        for s in reversed(steps):
            try:
                return self._restore_step(s, device, mesh, strategy)
            except TornCheckpointError as err:
                # crash-damaged snapshot: remember why and fall back to the
                # next-newest complete step
                torn.append((s, str(err)))
        raise FileNotFoundError(f"no restorable checkpoint in {self.dir}; all committed steps torn: {torn}")
