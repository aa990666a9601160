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

The port places only the expert stacks (:func:`shard_params`): each rank
keeps its ``[r*E/ep, (r+1)*E/ep)`` slice of every expert-stacked leaf.  The
dense leaves the specs put on ``model`` (attention, unembedding) stay
replicated in this slice; tensor-parallel dense layers come later.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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


def _map_with_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_pspecs(params: Any, mesh) -> Any:
    """Spec tree matching a params tree whose leaves have ``.shape``:
    tensor/expert parallelism over ``model``."""
    tied = "unembed" not in (params if isinstance(params, dict) else {})

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        if _leaf_name(path) == "embed" and not tied:
            # untied: the gather rides a d-sharded table, the vocab-sharded
            # unembed keeps the logits memory win
            model = _axis_size(mesh, "model")
            if len(shape) == 2 and shape[1] % model == 0:
                return (None, "model")
        return spec_for_param(path, shape, mesh)

    return _map_with_path(rule, params)


# ---------------------------------------------------------------------------
# batch / activations / cache
# ---------------------------------------------------------------------------


def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes carrying the batch: ('pod', 'data') multi-pod, ('data',) else."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


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
    """This rank's placement of ``params``: every expert-stacked leaf keeps
    the rank's :func:`expert_slice`, copied so the rest of the stack can be
    freed; every other leaf is kept whole (shared, not copied).  A one-rank
    ``model`` axis (or no mesh) returns ``params`` itself."""
    sl = expert_slice(cfg, mesh)
    if sl is None:
        return params
    return _map_with_path(
        lambda path, leaf: leaf[sl].clone() if is_expert_stack(path, tuple(leaf.shape)) else leaf, params)
