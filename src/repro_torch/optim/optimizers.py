"""Optimizers (the port's counterpart of ``repro/optim/optimizers.py``).

``Optimizer`` is an (init, update) pair:

    state = opt.init(params)
    params, state = opt.update(grads, state, params, step)

The reference returns an update tree that the step adds to the params; here
``update`` adds it in place, one leaf at a time under ``torch.no_grad()``,
and writes the state in place too, so the transient memory is a few
tensors of the largest leaf, never a second copy of the model (at
StarCoder2-3B's widths the params and AdamW's two moments are already
~36 GB of f32).  The arithmetic follows the reference's expression by
expression, its scalars (bias corrections, the learning rate) in f32.

Trees are the model's params layout (nested dicts and lists of tensors);
AdamW's state is ``{"m": tree, "v": tree}``, Adafactor's a tree of the
params' layout whose leaves are ``{"vr", "vc"}`` (factored, >= 2-D) or
``{"v"}``: the reference's state, leaf for leaf.

The reference keeps each layer leaf of a whole super-block stacked on a
leading super-block axis (its ``lax.scan`` layout), and its optimizers act
on those stacked arrays; the port keeps one dict per layer.  Given
``scan=(n_superblocks, pattern_length)`` (:func:`scan_of`) the port's
optimizers act as the reference's do on the stacked array the layer leaves
``layers[s * P + j]...`` (s < n_superblocks) form: its ``ndim`` (one more
than a layer's) picks AdamW's decay and Adafactor's factoring, and
Adafactor's update RMS is that of the whole stack.  A 1-D layer leaf (a
norm's scale) stacks to (n_superblocks, d): factored, its ``vr`` one 0-d
tensor a layer and its ``vc`` (d,) (the reference's column mean runs over
the super-block axis) held by the stack's first layer ``layers[j]`` alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

Params = Any
Schedule = Callable[[Any], float]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]  # (grads, state, params, step[, shards]) -> (params, state), in place


@dataclass(frozen=True)
class Shard:
    """A rank's shard of a leaf: the leaf split on tensor axis ``dim`` over
    the process ``group`` of ``size`` (> 1) ranks."""

    dim: int
    group: Any
    size: int


def _allsum(x: torch.Tensor, sh: Shard) -> torch.Tensor:
    x = x.contiguous()
    dist.all_reduce(x, group=sh.group)
    return x


def _mean(x: torch.Tensor, dim: Optional[int], split: Optional[int], sh: Optional[Shard]) -> torch.Tensor:
    """The mean of x over ``dim`` (None: every element) for a shard of a
    tensor split on its axis ``split`` (None: whole): the sum all-reduced
    over the shard's group where ``dim`` runs over the split axis, else
    torch's own mean."""
    if sh is None or split is None or (dim is not None and dim % x.ndim != split):
        return x.mean() if dim is None else x.mean(dim=dim)
    total = _allsum(x.sum() if dim is None else x.sum(dim=dim), sh)
    return total / ((x.numel() if dim is None else x.shape[dim]) * sh.size)


def _walk(structure, *trees, path: Tuple = ()) -> Iterator[Tuple]:
    """(path, leaf of ``structure``, the same place of each tree) over
    ``structure``'s tensor leaves, in its order; a tree may hold a subtree
    (Adafactor's per-leaf dicts) where ``structure`` holds a tensor."""
    if isinstance(structure, dict):
        for key in structure:
            yield from _walk(structure[key], *(t[key] for t in trees), path=path + (key,))
    elif isinstance(structure, (list, tuple)):
        for i, sub in enumerate(structure):
            yield from _walk(sub, *(t[i] for t in trees), path=path + (i,))
    else:
        yield (path, structure, *trees)


Scan = Optional[Tuple[int, int]]  # (super-blocks, pattern length) of the reference's stacked layer leaves


def scan_of(cfg) -> Tuple[int, int]:
    """``(n_superblocks, pattern_length)`` of a model config: the layers
    the reference stacks (the rest, a pattern-incomplete tail, it keeps
    unstacked)."""
    return cfg.num_layers // len(cfg.block_pattern), len(cfg.block_pattern)


def _groups(scan: Scan, structure, *trees) -> List[Tuple[bool, List[Tuple]]]:
    """:func:`_walk`'s items grouped as the reference stacks them:
    ``(stacked, items)``, items ``(path, leaf, ...)`` of the layers
    ``s * P + j`` in ascending s for one (pattern slot j, path within the
    layer), or one unstacked item."""
    n_sb, P = scan or (0, 1)
    out: List[Tuple[bool, List[Tuple]]] = []
    stacks = {}
    for item in _walk(structure, *trees):
        path = item[0]
        if path[:1] == ("layers",) and path[1] < n_sb * P:
            key = (path[1] % P, path[2:])
            if key not in stacks:
                stacks[key] = []
                out.append((True, stacks[key]))
            stacks[key].append(item)
        else:
            out.append((False, [item]))
    return out


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a tree of dicts and lists, in its order."""
    return [leaf for _, leaf in _walk(tree)]


def tree_unflatten(structure, leaves) -> Params:
    """A tree of ``structure``'s layout holding ``leaves`` (in
    :func:`tree_leaves`'s order)."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), structure)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def global_norm(tree, shards=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares in f32 (a 0-d tensor
    on the leaves' device; nothing is read back).  With ``shards`` a split
    leaf's sum is all-reduced over its group (one all-reduce a group, of
    the leaves' sums masked to its own), so each element counts once."""
    ss = torch.stack([torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)])
    if shards is not None:
        groups = {}
        for i, (_, _, sh) in enumerate(_walk(tree, shards)):
            if sh is not None:
                groups.setdefault(id(sh.group), (sh, []))[1].append(i)
        for sh, idx in groups.values():
            mask = torch.zeros(ss.shape, dtype=torch.bool, device=ss.device)
            mask[idx] = True
            ss = torch.where(mask, _allsum(torch.where(mask, ss, torch.zeros_like(ss)), sh), ss)
    return torch.sqrt(torch.sum(ss))


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float, shards=None) -> Tuple[Params, torch.Tensor]:
    """Scale ``grads`` in place by min(1, max_norm / norm); returns (grads,
    norm).  ``shards``: as :func:`global_norm`'s."""
    norm = global_norm(grads, shards)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _lr(lr, step) -> float:
    return lr(step) if callable(lr) else float(_f32(lr))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(
    lr: Schedule | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    decay_mask: Optional[Callable[[Tuple, Any], bool]] = None,
    scan: Scan = None,
) -> Optimizer:
    """AdamW with decoupled weight decay.  1-D params (norms, biases) are
    excluded from decay by default (a stacked layer leaf counts the
    super-block axis, ``scan``, as the reference does); ``decay_mask(path,
    p)`` overrides that (``path`` the leaf's keys and list indices)."""

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": _tree_map(zeros, params), "v": _tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        step_f = _f32(int(step)) + 1.0
        bc1 = float(1.0 - _f32(b1) ** step_f)
        bc2 = float(1.0 - _f32(b2) ** step_f)
        lr_t = _lr(lr, step)
        lr_wd = float(_f32(lr_t) * _f32(weight_decay))
        stacked = {item[0] for st, items in _groups(scan, params) if st for item in items}
        for path, p, g, m, v in _walk(params, grads, state["m"], state["v"]):
            g32 = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            u = m / bc1
            u.mul_(-lr_t).div_((v / bc2).sqrt_().add_(eps))
            if decay_mask(path, p) if decay_mask is not None else p.ndim + (path in stacked) >= 2:
                u.sub_(lr_wd * p.to(torch.float32))
            p.add_(u.to(p.dtype))
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------


def adafactor(
    lr: Schedule | float,
    *,
    decay_rate: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    scan: Scan = None,
) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018), simplified as the reference: factored
    v for ndim >= 2 (row / column means over the last two axes), full v
    otherwise; update RMS clipping; no first moment.  ``scan``: the layer
    leaves the reference stacks are updated as their stack (module
    docstring): factored, one RMS a stack."""

    def one(p):
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def init(params):
        state = _tree_map(one, params)
        for stacked, items in _groups(scan, params):
            p = items[0][1]
            if stacked and p.ndim == 1:  # (n, d): a row mean a layer, the column mean in the first
                for i, (path, _) in enumerate(items):
                    s = {"vr": torch.zeros((), dtype=torch.float32, device=p.device)}
                    if i == 0:
                        s["vc"] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    _set(state, path, s)
        return state

    def _u(g, s, sh=None):
        """The unclipped update of one leaf (a layer of a stack) from its updated state."""
        g32 = g.to(torch.float32)
        if "v" in s:
            return g32 * torch.rsqrt(torch.clamp(s["v"], min=eps))
        vr_split = None if sh is None or sh.dim == g.ndim - 1 else sh.dim  # vr drops the last axis
        r = (s["vr"] / torch.clamp(_mean(s["vr"], -1, vr_split, sh).unsqueeze(-1), min=eps))[..., None]
        return g32 * torch.rsqrt(torch.clamp(r * s["vc"][..., None, :], min=eps))

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        beta2_t = 1.0 - (_f32(int(step)) + 1.0) ** (-decay_rate)
        beta2, one_minus = float(beta2_t), float(1.0 - beta2_t)
        lr_t = _lr(lr, step)
        lr_wd = float(_f32(lr_t) * _f32(weight_decay))
        if shards is None:
            shards = _tree_map(lambda _: None, params)
        for stacked, items in _groups(scan, params, grads, state, shards):
            p0, sh = items[0][1], items[0][4]
            layer_u = _u
            if stacked and p0.ndim == 1:
                vc = items[0][3]["vc"]
                col = torch.zeros_like(vc)
                for _, _, g, s, _ in items:
                    g2 = g.to(torch.float32) ** 2 + eps
                    s["vr"].mul_(beta2).add_(one_minus * _mean(g2, None, 0, sh))
                    col.add_(g2)
                vc.mul_(beta2).add_(one_minus * (col / len(items)))
                denom = torch.clamp(torch.stack([s["vr"] for *_, s, _ in items]).mean(), min=eps)

                def layer_u(g, s, sh=None):
                    return g.to(torch.float32) * torch.rsqrt(torch.clamp((s["vr"] / denom) * vc, min=eps))
            else:
                for _, p, g, s, sh in items:
                    g2 = g.to(torch.float32) ** 2 + eps
                    if p.ndim >= 2:
                        split = None if sh is None else sh.dim
                        s["vr"].mul_(beta2).add_(one_minus * _mean(g2, -1, split, sh))
                        s["vc"].mul_(beta2).add_(one_minus * _mean(g2, -2, split, sh))
                    else:
                        s["v"].mul_(beta2).add_(one_minus * g2)
                    del g2
            # the RMS of the (stacked) leaf's update, then each layer's update again, clipped by it
            if len(items) > 1:
                ss = sum(torch.sum(layer_u(g, s, sh) ** 2) for _, _, g, s, sh in items)
                if sh is not None:
                    ss = _allsum(ss, sh)
                rms = torch.sqrt(ss / (len(items) * p0.numel() * (sh.size if sh is not None else 1)) + 1e-30)
            for _, p, g, s, sh in items:
                u = layer_u(g, s, sh)
                if len(items) == 1:
                    rms = torch.sqrt(_mean(u * u, None, None if sh is None else sh.dim, sh) + 1e-30)
                u.div_(torch.clamp(rms / clip_threshold, min=1.0)).mul_(-lr_t)
                if weight_decay and p.ndim + stacked >= 2:
                    u.sub_(lr_wd * p.to(torch.float32))
                p.add_(u.to(p.dtype))
        return params, state

    return Optimizer(init, update)


def _set(tree, path, value) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def make_optimizer(name: str, lr: Schedule | float, **kw) -> Optimizer:
    """``adamw`` or ``adafactor`` with ``lr`` and keyword arguments ``kw``
    (``scan``: :func:`scan_of` a model config, as the train step passes it)."""
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
