"""Sharding rules (port of ``repro/parallel/sharding.py``): which mesh axis
each parameter, batch and cache tensor is split over, and the placement of a
rank's expert slice.

A spec is a tuple with one entry per tensor axis (``None``, an axis name, or
a tuple of axis names), the port's form of a ``PartitionSpec``; ``()`` means
replicated.  A leaf's ``path`` is the sequence of keys leading to it (dict
keys as strings, list indices as ints), and only its names are read.

Axes:
  pod    inter-pod data parallelism
  data   intra-pod data parallelism (batch)
  model  tensor / expert parallelism (heads, FFN hidden, experts, vocab)

The rules are preference lists resolved against divisibility: for each
parameter kind the preferred tensor axes are tried in order and the first
whose size divides the ``model`` axis is sharded; otherwise the tensor is
replicated.

Training places every leaf by :func:`param_pspecs` under either strategy
(:func:`shard_tree` cuts a rank's shards from whole leaves, :func:`gather_leaf`
undoes it): ``tp`` puts each leaf on ``model`` by :func:`spec_for_param`
(experts on their E axis, attention on heads, ...), ``fsdp`` splits each
leaf over every mesh axis (:func:`fsdp_spec_for_param`).  The port's ``tp``
places weights as the reference does but gathers a dense leaf whole before
it is used (the train step's ``gather``): it does not split a dense layer's
computation across the ``model`` ranks, as GSPMD does for the reference.
Serving places the ``tp`` rule's expert stacks only (:func:`shard_params`:
each rank keeps its ``[r*E/ep, (r+1)*E/ep)`` slice of every expert-stacked
leaf) and keeps its dense leaves whole.

A shard's index along a spec entry of several axes is its row-major
position over those axes in the mesh's order, which is its rank in the
entry's process group (``mesh.group(axes)``), so gathers concatenate in
group-rank order.  The port keeps one dict per layer where the reference
stacks layers on a super-block axis; specs are taken on the layer's own
shape (a path without ``scan``), so under ``fsdp`` a leaf the reference
would split on its super-block axis splits on a layer axis here.  The
numbers do not depend on placement: a checkpoint holds whole leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]

# Preference lists: param-name suffix -> ordered tensor axes to try sharding
# over "model".  Axis indices refer to the parameter's own shape.
_MODEL_AXIS_PREFS: Dict[str, Tuple[int, ...]] = {
    # embeddings: vocab first, then d_model
    "embed": (0, 1),
    "unembed": (0, 1),
    # attention
    "wq": (1, 2),      # (d, nq, hd): heads, else head_dim
    # KV projections: heads when divisible, else replicate (a hd-sharded K
    # turns the score tensor into partial sums needing an all-reduce)
    "wk": (1,),        # (d, nkv, hd)
    "wv": (1,),
    "wo": (0, 1),      # (nq, hd, d): heads, else head_dim (contracting side)
    "bq": (0, 1),
    "bk": (0,),
    "bv": (0,),
    # dense FFN (SwiGLU): hidden axis
    "w_gate": (1,),    # (d, f) / shared (d, sh*f) / expert (E, d, f) handled below
    "w_up": (1,),
    "w_down": (0,),    # (f, d)
    # recurrent (RG-LRU): width axis
    "w_x": (1,),
    "conv_w": (1,),
    "conv_b": (0,),
    "alpha_r": (0,),
    "b_r": (0,),
    "alpha_i": (0,),
    "b_i": (0,),
    "lam": (0,),
    "w_out": (0,),     # (w, d) / ssm (d_in, d): contracting side
    # SSM (Mamba-2): packed projection output axis
    "w_in": (1,),
    "A_log": (0,),
    "D": (0,),
    "dt_bias": (0,),
    # frontend stub
    "proj": (1,),
    # per-expert int8 scale control words (E,): expert axis, same as stacks
    "w_gate_s": (0,),
    "w_up_s": (0,),
    "w_down_s": (0,),
}

# Expert-stacked params (leading E axis): experts shard over "model"; the
# int8 twins ("_q") shard identically, and so do their (E,) scale words.
_EXPERT_PARAMS = {"w_gate", "w_up", "w_down", "w_gate_q", "w_up_q", "w_down_q"}
_EXPERT_SCALES = {"w_gate_s", "w_up_s", "w_down_s"}

# Always-replicated small params.
_REPLICATED = {"ln1", "ln2", "final_norm", "q_norm", "k_norm", "norm_scale", "router"}


def _leaf_name(path: Sequence) -> str:
    """The last string key along a path."""
    for k in reversed(tuple(path)):
        if isinstance(k, str):
            return k
    return ""


def _path_has(path: Sequence, name: str) -> bool:
    return any(k == name for k in path)


def _axis_size(mesh, name: str) -> int:
    return int(mesh.shape.get(name, 1))


def _entry(axes: Sequence[str]):
    """One spec entry over ``axes``: a single axis is its name (as
    ``PartitionSpec`` normalises a 1-tuple), several a tuple, none None."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def is_expert_stack(path: Sequence, shape: Tuple[int, ...]) -> bool:
    """The one rule for which leaves split over experts, read by
    :func:`spec_for_param` and :func:`shard_params`: an expert-named leaf
    outside ``shared`` with a leading E axis (after a scan-stack axis, where
    the path passes through ``scan``): the (E, ., .) stacks, their int8
    twins and the twins' (E,) scale words."""
    stack = 1 if _path_has(path, "scan") else 0
    name, rank = _leaf_name(path), len(shape) - stack
    return ((name in _EXPERT_PARAMS and rank == 3) or (name in _EXPERT_SCALES and rank == 1)) \
        and not _path_has(path, "shared")


def spec_for_param(path: Sequence, shape: Tuple[int, ...], mesh) -> Spec:
    """Spec for one parameter leaf (a leading layer-stack axis is present
    when the path passes through ``scan``, as in the reference's tree)."""
    name = _leaf_name(path)
    model_size = _axis_size(mesh, "model")
    ndim = len(shape)

    def with_model_axis(axis: int) -> Spec:
        spec = [None] * ndim
        spec[axis] = "model"
        return tuple(spec)

    if name in _REPLICATED:
        return ()
    stack = 1 if _path_has(path, "scan") else 0
    if is_expert_stack(path, shape) and shape[stack] % model_size == 0:
        return with_model_axis(stack)
    for ax in _MODEL_AXIS_PREFS.get(name, ()):
        ax = ax + stack
        if ax < ndim and shape[ax] % model_size == 0 and shape[ax] >= model_size:
            return with_model_axis(ax)
    return ()


def map_with_path(fn: Callable, tree: Any, *others: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf, *others' leaves)`` over a tree of dicts and lists
    (anything else is a leaf), each of ``others`` walked in the tree's
    layout (its leaves may be anything, a spec's tuple or a dict)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(o[k] for o in others), path=path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, *(o[i] for o in others), path=path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree, *others)


def map_specs(fn: Callable, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    return map_with_path(lambda _, leaf, spec: fn(leaf, spec), tree, specs)


STRATEGIES = ("tp", "fsdp")


def param_pspecs(params: Any, mesh, *, strategy: str = "tp") -> Any:
    """Spec tree matching a params tree whose leaves have ``.shape``.

    ``strategy="tp"`` (default): each leaf on the ``model`` axis by
    :func:`spec_for_param` (the untied embedding on d, so its gather needs no
    collective and the vocab-sharded unembedding keeps the logits' memory
    win).  ``strategy="fsdp"``: every leaf split over all mesh axes
    (:func:`fsdp_spec_for_param`), gathered on use and reduce-scattered on
    the way back."""
    tied = "unembed" not in (params if isinstance(params, dict) else {})
    return map_with_path(lambda path, leaf: leaf_spec(path, tuple(leaf.shape), mesh, strategy, tied), params)


def leaf_spec(path: Sequence, shape: Tuple[int, ...], mesh, strategy: str = "tp", tied: bool = True) -> Spec:
    """:func:`param_pspecs`' rule for one leaf (``tied``: the params have
    no ``unembed`` leaf)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    if strategy == "fsdp":
        return fsdp_spec_for_param(shape, mesh)
    if _leaf_name(path) == "embed" and not tied and len(path) == 1:
        # untied: the gather rides a d-sharded table, the vocab-sharded
        # unembed keeps the logits memory win
        if len(shape) == 2 and shape[1] % _axis_size(mesh, "model") == 0:
            return (None, "model")
    return spec_for_param(path, shape, mesh)


def fsdp_spec_for_param(shape: Tuple[int, ...], mesh) -> Spec:
    """Split the largest axis divisible by the whole device count over all
    mesh axes; else the largest axis divisible by the largest single mesh
    axis that divides any; else replicate."""
    axes = [a for a in ("data", "model", "pod") if a in mesh.shape]
    total = 1
    for a in axes:
        total *= _axis_size(mesh, a)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % total == 0 and shape[i] >= total:
            spec = [None] * len(shape)
            spec[i] = tuple(axes)
            return tuple(spec)
    for a in sorted(axes, key=lambda a: -_axis_size(mesh, a)):
        for i in order:
            if shape[i] % _axis_size(mesh, a) == 0 and shape[i] >= _axis_size(mesh, a):
                spec = [None] * len(shape)
                spec[i] = a
                return tuple(spec)
    return ()


def moment_spec(name: str, spec: Spec) -> Spec:
    """The spec of an optimizer moment of a leaf placed by ``spec``, by the
    moment's name: AdamW's ``m``/``v`` and Adafactor's full ``v`` the
    leaf's; Adafactor's row mean ``vr`` (the last axis reduced) and column
    mean ``vc`` (the second-to-last reduced) keep the split axis where it
    survives the factoring, else replicate.  For every leaf of the port
    this is the reference's rule, which tells them apart by shape (a
    stacked 1-D leaf's 0-d ``vr`` replicates; its ``vc`` is the leaf's
    shape and keeps its spec)."""
    entries = list(spec)
    if name == "vr":
        return tuple(entries[:-1])
    if name == "vc":
        return tuple(entries[:-2] + entries[-1:])
    return tuple(spec)


def opt_state_pspecs(opt_state: Any, params: Any, mesh, *, strategy: str = "tp") -> Any:
    """Specs of an optimizer state from the params' whole leaves' shapes:
    AdamW's ``{"m", "v"}`` mirror the params; Adafactor's per-leaf dicts
    (``{"vr", "vc"}`` or ``{"v"}``) by :func:`moment_spec` (the reference's
    ``opt_state_pspecs``).  Only the state's layout is read, so its leaves
    may be whole or a rank's shards."""
    pspecs = param_pspecs(params, mesh, strategy=strategy)
    if isinstance(opt_state, dict) and set(opt_state) <= {"m", "v"}:
        return {k: pspecs for k in opt_state}

    return map_with_path(lambda _, leaf, spec, st: {k: moment_spec(k, spec) for k in st}, params, pspecs, opt_state)


class Placement(NamedTuple):
    """Where a leaf's shard sits: split on tensor axis ``dim`` over the mesh
    axes ``axes`` (in the mesh's order) in ``size`` blocks, this rank's block
    ``index``."""

    dim: int
    axes: Tuple[str, ...]
    size: int
    index: int


def placement(spec: Spec, mesh) -> Optional[Placement]:
    """The :class:`Placement` a spec gives this rank of ``mesh``, or None
    for a replicated leaf (a spec splits at most one tensor axis)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        axes = tuple(a for a in mesh.axis_names if a in names)
        size, index = 1, 0
        for a in axes:
            size *= _axis_size(mesh, a)
            index = index * _axis_size(mesh, a) + mesh.coords[a]
        return Placement(dim, axes, size, index)
    return None


def cut(leaf, spec: Spec, mesh):
    """This rank's shard of a whole leaf (a tensor or an array; a tensor
    shard is a contiguous copy, so the whole leaf can be freed; a leaf
    split one way is returned as it is)."""
    pl = placement(spec, mesh)
    if pl is None or pl.size == 1:
        return leaf
    n = leaf.shape[pl.dim]
    if n % pl.size:
        raise ValueError(f"axis {pl.dim} of a {tuple(leaf.shape)} leaf does not split over {pl.axes} ({pl.size})")
    b = n // pl.size
    if isinstance(leaf, torch.Tensor):
        return leaf.narrow(pl.dim, pl.index * b, b).clone()
    index = [slice(None)] * leaf.ndim
    index[pl.dim] = slice(pl.index * b, (pl.index + 1) * b)
    return leaf[tuple(index)]


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's shards of a tree of whole leaves, by a spec tree of its
    layout (:func:`param_pspecs`, :func:`opt_state_pspecs`)."""
    return map_specs(lambda leaf, spec: cut(leaf, spec, mesh), tree, specs)


def gather_leaf(shard: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's shard (an all-gather over the
    spec's group; every rank of it calls this); a replicated leaf, or one
    split one way, is returned as it is."""
    from repro_torch.parallel.collectives import all_gather_dim

    pl = placement(spec, mesh)
    if pl is None or pl.size == 1:
        return shard
    return all_gather_dim(shard, mesh.group(pl.axes), pl.dim)


def serve_leaf_spec(path: Sequence, shape: Tuple[int, ...], mesh) -> Spec:
    """The serving plane's rule for one leaf: the ``tp`` rule's spec of an
    expert stack (:func:`is_expert_stack`), every other leaf whole."""
    return spec_for_param(path, shape, mesh) if is_expert_stack(path, shape) else ()


def serve_pspecs(params: Any, mesh) -> Any:
    """The serving plane's placement, :func:`serve_leaf_spec` leaf by leaf."""
    return map_with_path(lambda path, leaf: serve_leaf_spec(path, tuple(leaf.shape), mesh), params)


def serve_shard_pspecs(shards: Any, mesh) -> Any:
    """:func:`serve_pspecs` of the whole leaves, read from a serving rank's
    shares (:func:`shard_params`): an expert stack's leading E axis holds
    E / ep experts of the whole stack's E."""
    ep = _axis_size(mesh, "model")

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if is_expert_stack(path, shape):
            stack = 1 if _path_has(path, "scan") else 0
            shape = shape[:stack] + (shape[stack] * ep,) + shape[stack + 1:]
        return serve_leaf_spec(path, shape, mesh)

    return map_with_path(one, shards)


# ---------------------------------------------------------------------------
# batch / activations / cache
# ---------------------------------------------------------------------------


def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes carrying the batch: ('pod', 'data') multi-pod, ('data',) else."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_axes(batch: int, mesh) -> Tuple[str, ...]:
    """The data axes :func:`batch_spec` splits a batch of ``batch`` over (a
    tuple, empty when none divides it)."""
    first = batch_spec(batch, mesh)[0]
    return () if first is None else (first,) if isinstance(first, str) else tuple(first)


def batch_spec(batch: int, mesh, extra_dims: int = 1) -> Spec:
    """Shard the leading batch dim over as many data axes as divide it."""
    axes = []
    prod = 1
    for a in data_axes(mesh):
        if batch % (prod * _axis_size(mesh, a)) == 0:
            axes.append(a)
            prod *= _axis_size(mesh, a)
    return (_entry(axes),) + (None,) * extra_dims


def cache_spec_for(path: Sequence, shape: Tuple[int, ...], batch: int, mesh) -> Spec:
    """Decode-cache leaves: batch on data axes; heads/width/state on model.

    KV cache (B, S, nkv, hd); RG-LRU h (B, W) / conv (B, K-1, W); SSD h
    (B, H, N, P) / conv (B, K-1, ch); the paged pool (R, nkv, hd) has no
    batch axis; DecodePlan rows stay replicated over ``model`` (every shard
    filters them against its resident experts).  A leading scan-stack axis
    may be present."""
    name = _leaf_name(path)
    model_size = _axis_size(mesh, "model")
    stack = 1 if _path_has(path, "scan") else 0
    baxes = batch_spec(batch, mesh)[0]
    spec = [None] * len(shape)
    if name not in ("pk", "pv", "pks", "pvs") and len(shape) > stack:
        spec[stack] = baxes

    def try_model(ax: int) -> bool:
        ax = ax + stack
        if ax < len(shape) and shape[ax] % model_size == 0 and shape[ax] >= model_size:
            spec[ax] = "model"
            return True
        return False

    if name in ("pks", "pvs"):
        pass
    elif name in ("pk", "pv"):
        try_model(1) or try_model(0) or try_model(2)
    elif name in ("k", "v"):
        try_model(2) or try_model(1) or try_model(3)
    elif name == "h":
        if len(shape) - stack == 2:
            try_model(1)
        else:
            try_model(1) or try_model(2)
    elif name == "conv":
        try_model(2)
    return tuple(spec)


def expert_slice(cfg, mesh: Optional[Any]) -> Optional[slice]:
    """The rank's slice ``[r*E/ep, (r+1)*E/ep)`` of the expert axis, or None
    when the ``model`` axis has one rank (or there is no mesh)."""
    ep = _axis_size(mesh, "model") if mesh is not None else 1
    if ep == 1:
        return None
    E = cfg.num_experts
    if E % ep:
        raise ValueError(f"{E} experts are not divisible by the 'model' mesh axis ({ep})")
    e_loc, r = E // ep, mesh.coords["model"]
    return slice(r * e_loc, (r + 1) * e_loc)


def shard_params(params: Any, cfg, mesh: Optional[Any]) -> Any:
    """This rank's serving placement of ``params`` (:func:`serve_pspecs`):
    every expert-stacked leaf keeps the rank's :func:`expert_slice`,
    copied so the rest of the stack can be freed; every other leaf is kept
    whole (shared, not copied).  A one-rank ``model`` axis (or no mesh)
    returns ``params`` itself."""
    if expert_slice(cfg, mesh) is None:
        return params
    return shard_tree(params, serve_pspecs(params, mesh), mesh)
