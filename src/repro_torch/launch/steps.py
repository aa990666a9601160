"""The serve launches (the port's counterpart of ``repro/launch/steps.py``):
:func:`build_spec_serve_step`, the decode launch captured once in a CUDA
graph and replayed (the counterpart of the reference's jitted
``build_spec_serve_step``), :class:`TreeCommit`, the contiguous tree commit
compiled the same way (the reference's jitted ``_commit``),
:func:`admission` (a fork's too), :func:`build_model`, which binds a model
to a mesh, and the two operations request programs run on the card outside
the graphs: the masked verify (:func:`masked_argmax_rows`) and the guided
ranking (:func:`masked_top_k`) over a program's allowed-token table
(:class:`ProgramTable`).

A compiled launch (:class:`CompiledLaunch`) owns static device buffers for
its inputs and is bound to the cache and parameter tensors its body reads
and writes in place.  On the card its first call runs the body eagerly on
the replica's capture stream (the warm-up: kernels built and loaded, their
attributes set, lazily made constants such as the rotary frequencies and
the tree's control words filled), then captures the body with
``torch.cuda.graph``; every later call copies the host inputs through
pinned staging buffers into the static buffers and replays the graph.  A
failure to capture or replay raises: nothing on the card falls back to an
eager launch.  On the CPU there are no graphs: the same object runs the
body eagerly on its static buffers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.control_plane import _top_k
from repro_torch.core.plans import TreePlan
from repro_torch.kernels import add_launch_counts, recorded_launches
from repro_torch.models.layers import Params
from repro_torch.models.model import Model
from repro_torch.models.transformer import STATE_KINDS, decode_constants, max_pages_for
from repro_torch.parallel.moe_parallel import make_sharded_decode_apply, make_sharded_moe_apply
from repro_torch.parallel.sharding import batch_spec, expert_slice


def build_model(cfg: ModelConfig, mesh, batch: int, device=None) -> Model:
    """A model whose MoE layers run on ``mesh``: the expert-parallel prefill
    apply, and on the decode plane the shard-sliced decode apply (which
    raises, not falls back, when the experts do not divide the ``model``
    axis), as the reference's ``build_model`` binds them.  The batch axes
    are the data axes that divide ``batch``.  No dense layer is sharded, so
    the reference's residual constraint is the identity here.  ``mesh=None``
    is the single-host model on ``device``; with a mesh the model lives on
    the mesh's device and its ``init`` draws this rank's expert slice."""
    if mesh is None:
        return Model(cfg, device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
    baxes = batch_spec(batch, mesh)[0] or ()
    baxes = (baxes,) if isinstance(baxes, str) else tuple(baxes)
    moe_apply = decode_apply = None
    if cfg.is_moe:
        moe_apply = make_sharded_moe_apply(cfg, mesh, baxes)
        if cfg.decode_plane:
            decode_apply = make_sharded_decode_apply(cfg, mesh, baxes)
    return Model(cfg, mesh.device, moe_apply=moe_apply, decode_moe_apply=decode_apply,
                 experts=expert_slice(cfg, mesh) if cfg.is_moe else None)


def prefill_model(model: Model) -> Model:
    """The B=1 admission prefill's model: under ``cfg.paged`` a contiguous
    twin with the same MoE applies (prefill writes stripes; the pool is
    seeded by a row scatter)."""
    if not model.cfg.paged:
        return model
    return Model(dataclasses.replace(model.cfg, paged=False), model.device, moe_apply=model.moe_apply,
                 decode_moe_apply=model.decode_moe_apply, experts=model.experts)


def admission(
    model: Model, params: Params, cache: List[Params], prompt: np.ndarray, slot: Union[int, Sequence[int]],
    rows: Union[None, np.ndarray, Sequence[np.ndarray]] = None, pf_model: Optional[Model] = None,
) -> torch.Tensor:
    """B=1 prefill of ``prompt`` into batch row ``slot`` -> last-position
    logits (V,).

    Contiguous: the prefill writes straight into the slot (the reference
    prefills a fresh B=1 cache and copies it in; the slot ends up holding
    the same rows).  Paged (``rows`` given, the (max_len,) physical-row
    vector of the replica's page binding): a contiguous B=1 prefill into a
    fresh cache of ``pf_model`` (see :func:`prefill_model`), then only the
    rows the vector names are written into the pool.

    A fork admits one prompt into several slots off ONE prefill: ``slot``
    is then the list of slots and, paged, ``rows`` one vector per slot.
    Contiguous, every cache leaf of the first slot (K/V, plan rows, rolling
    buffers, recurrent state) is copied to the others; paged, the one B=1
    cache is written through each slot's vector (full prompt pages the
    trie already shares are never written again)."""
    slots = [int(slot)] if np.ndim(slot) == 0 else [int(b) for b in slot]
    prompt = np.asarray(prompt)[None]
    if rows is None:
        logits = model.prefill(params, prompt, cache, slot=slots[0])[0]
        for b in slots[1:]:
            model.copy_cache_slot(cache, slots[0], b)
        return logits
    vectors = [rows] if np.ndim(slot) == 0 else list(rows)
    pf_model = pf_model or prefill_model(model)
    one = pf_model.init_cache(1, len(vectors[0]))
    logits = pf_model.prefill(params, prompt, one)[0]
    for b, r in zip(slots, vectors):
        model.write_cache_slot_paged(cache, one, b, r)
    return logits


# ---------------------------------------------------------------------------
# request programs on the card: masked verify and the guided drafter's ranking
# ---------------------------------------------------------------------------


class ProgramTable:
    """One compiled request program's allowed sets, made once per program:
    ``allowed`` the (S, V) bool table ``trans >= 0`` on ``device``, and on
    the host ``allowed_count`` (S,) and ``masked_frac`` (S,), the share of
    the vocabulary each state masks (the reference's ``1 - mask.mean()``)."""

    def __init__(self, program, device):
        self.program = program
        self.automaton = program.automaton
        mask = self.automaton.trans >= 0
        self.allowed = torch.as_tensor(mask, device=device)
        self.allowed_count = mask.sum(axis=1)
        self.masked_frac = 1.0 - mask.mean(axis=1)

    @property
    def nbytes(self) -> int:
        return self.allowed.numel() * self.allowed.element_size()


def _masked(logits: torch.Tensor, allowed: torch.Tensor, rows: np.ndarray, states: np.ndarray) -> torch.Tensor:
    """(M, V) f32: ``logits[row]`` where ``allowed[state]`` admits the
    token, the f32 minimum elsewhere (the reference's fill), per pair."""
    dev = logits.device
    sel = logits.index_select(0, torch.as_tensor(rows, dtype=torch.int64, device=dev)).float()
    ok = allowed.index_select(0, torch.as_tensor(states, dtype=torch.int64, device=dev))
    return torch.where(ok, sel, torch.finfo(torch.float32).min)


def masked_argmax_rows(logits: torch.Tensor, allowed: torch.Tensor, rows: np.ndarray,
                       states: np.ndarray) -> torch.Tensor:
    """The masked verify: for each (row, state) pair, the argmax of
    ``logits[row]`` over the tokens ``allowed[state]`` admits -> (M,) ids
    on the logits' device; ties go to the first maximum, as the
    reference's ``masked_argmax`` (``np.argmax``) takes them."""
    return _masked(logits, allowed, rows, states).argmax(-1)


def masked_top_k(logits: torch.Tensor, allowed: torch.Tensor, rows: np.ndarray, states: np.ndarray,
                 k: int) -> torch.Tensor:
    """The guided ranking: for each (row, state) pair, the ``k`` best
    tokens of ``logits[row]`` among those ``allowed[state]`` admits, best
    first, ties to the lower id (a stable descending sort, the order of
    the reference's ``np.argsort(-masked, kind="stable")``); past the
    allowed count come disallowed ids.  (M, k) ids on the logits' device."""
    return _top_k(_masked(logits, allowed, rows, states), k)[1]


# ---------------------------------------------------------------------------
# compiled launches (CUDA graphs)
# ---------------------------------------------------------------------------


def _slots(tree, out: Optional[list] = None) -> List[Tuple[dict, str]]:
    """(dict, key) of every tensor leaf of nested dicts and lists, found once
    so that a launch's binding check is one flat pass."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for key, value in tree.items():
            if isinstance(value, torch.Tensor):
                out.append((tree, key))
            else:
                _slots(value, out)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            _slots(value, out)
    return out


class GraphPool:
    """The memory pool and the capture stream that every CUDA graph of one
    replica shares (its decode step, its tree commit, its drafter's step).
    Graphs that share a pool must replay in one stream's order, never two
    at once, as one replica's launches do."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)

    def reserved_bytes(self) -> Optional[int]:
        """Bytes of card memory the pool holds (the allocator's snapshot),
        or None where the snapshot names no pool."""
        segments = torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None
        return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == tuple(self.handle))


class CompiledLaunch:
    """``body(inputs) -> tuple of output tensors`` over static input buffers
    ``inputs`` (name -> (shape, dtype)) on ``device``, bound to the tensor
    leaves of ``bound`` (nested dicts and lists: every tensor the body reads
    or writes in place, whose addresses a graph keeps).  A call raises if a
    leaf was replaced in its dict (or re-pointed) instead of written in
    place.

    On the card the outputs of a replay are the graph's static tensors
    (``outputs``), overwritten by the next call; the first call's are its
    warm-up's, copied there.  The kernel launches the capture counted
    (``replay_launches``) are added to the wrappers' counters at each
    replay, so a replay counts as an eager launch does."""

    def __init__(self, body: Callable, inputs: Dict[str, Tuple[tuple, torch.dtype]], bound, device,
                 graphs: Optional[GraphPool] = None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._body, self._bound = body, _slots(bound)
        self.inputs = {n: torch.zeros(shape, dtype=dt, device=self.device) for n, (shape, dt) in inputs.items()}
        self._ptrs = [d[k].data_ptr() for d, k in self._bound]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.replay_launches: Dict[str, int] = {}
        self.capture_s: Optional[float] = None
        if self.cuda:
            self.graphs = graphs or GraphPool(self.device)
            self._staging = {n: torch.zeros(shape, dtype=dt, pin_memory=True) for n, (shape, dt) in inputs.items()}
            self._staged = torch.cuda.Event()

    def check_binding(self) -> None:
        """Raise if a bound leaf was replaced (or re-pointed) since the
        launch was built: one host pass over the leaves, every call."""
        if [d[k].data_ptr() for d, k in self._bound] != self._ptrs:
            raise RuntimeError("a tensor this launch is bound to was replaced instead of written in place: "
                               "build the launch again for the new cache or parameters")

    def __call__(self, arrays: Dict[str, np.ndarray]) -> Tuple[torch.Tensor, ...]:
        self.check_binding()
        for name, a in arrays.items():
            if a.shape != tuple(self.inputs[name].shape):
                raise ValueError(f"{name} of shape {a.shape} for a launch built for {tuple(self.inputs[name].shape)}")
        if not self.cuda:
            for name, a in arrays.items():
                self.inputs[name].copy_(torch.from_numpy(a))
            self.outputs = self._body(self.inputs)
            return self.outputs
        self._staged.synchronize()  # the previous call's copies have left the staging buffers
        for name, a in arrays.items():
            np.copyto(self._staging[name].numpy(), a)
            self.inputs[name].copy_(self._staging[name], non_blocking=True)
        self._staged.record()
        if self.graph is None:
            self._capture()
        else:
            self.graph.replay()
            add_launch_counts(self.replay_launches)
        return self.outputs

    def _capture(self) -> None:
        """This call's launch run eagerly on the capture stream (the
        warm-up), then the body captured: the capture runs no kernel, so the
        cache is written once."""
        cur, side = torch.cuda.current_stream(self.device), self.graphs.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self._body(self.inputs)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with recorded_launches() as taken:
            # thread_local: a host sync in this thread breaks the capture,
            # one in another thread (NCCL's watchdog polling its events) does not
            with torch.cuda.graph(graph, pool=self.graphs.handle, stream=side, capture_error_mode="thread_local"):
                outputs = self._body(self.inputs)
        self.capture_s = time.perf_counter() - t0
        for out, got in zip(outputs, first):
            out.copy_(got)
            got.record_stream(cur)
        self.graph, self.outputs, self.replay_launches = graph, outputs, taken


class _SpecServeStep:
    """One speculative decode launch of ``model`` over ``cache`` with
    ``params``, compiled (:class:`CompiledLaunch`) for one shape key
    ``(batch, T, tree, plane, telemetry)``; the plane is contiguous, paged
    chain or paged branchy, read from the cache.  Its static inputs are
    tokens (B, T), lengths and prev_accept (B,), under the paged plane the
    block table (B, max_pages) int32 and, for a branchy tree, the commit
    maps dst and src (B, T); its outputs are the logits (B, T, V)
    (:attr:`logits`), the greedy ids (B, T) and, with telemetry, the summed
    plan agreement.  A call checks its inputs as
    :meth:`Model.decode_tokens` does and returns (the greedy ids on the
    host, the plan agreement or None): only the B*T ids (and the agreement
    scalar) cross to the host.

    The body also takes the device constants it reads from process-wide
    caches (:func:`repro_torch.models.transformer.decode_constants`), and
    the step keeps the last run's: a graph keeps their addresses, so they
    live as long as it does, whatever the caches evict.  With :attr:`recorder` set to a list, each
    call appends its checked host inputs ``(tokens, lengths, prev_accept,
    {"pages": ..., "commit": ...})`` (copies), in the form a call takes."""

    def __init__(self, model: Model, params: Params, cache: List[Params], *, batch: int,
                 tree: Optional[TreePlan] = None, telemetry: bool = False, max_len: Optional[int] = None,
                 graphs: Optional[GraphPool] = None):
        cfg = model.cfg
        Tn = tree.num_nodes if tree is not None else max(cfg.spec_tokens, 1)
        attn = [c for kind, c in zip(cfg.layer_kinds, cache) if kind not in STATE_KINDS]
        paged = bool(attn) and "pk" in attn[0]
        self.branchy = paged and tree is not None and not tree.is_chain()
        self.plane = "paged branchy" if self.branchy else "paged chain" if paged else "contiguous"
        self.key = (batch, Tn, tree, self.plane, telemetry)
        self.model, self.params, self.cache = model, params, cache
        self.tree, self.telemetry, self.max_len = tree, telemetry, max_len
        inputs = {"tokens": ((batch, Tn), torch.int64), "lengths": ((batch,), torch.int64),
                  "prev_accept": ((batch,), torch.int64)}
        if paged:
            if max_len is None:
                raise ValueError("a paged step needs max_len, which sets its block table's width")
            inputs["pages"] = ((batch, max_pages_for(cfg, max_len)), torch.int32)
        if self.branchy:
            inputs["dst"] = inputs["src"] = ((batch, Tn), torch.int64)
        plan = tree if tree is not None else TreePlan.chain(Tn)
        branchy = self.branchy
        self.recorder: Optional[list] = None
        self._constants: List[torch.Tensor] = []
        held = self._constants

        def body(x):
            held[:] = decode_constants(cfg, plan, x["tokens"].device)
            logits, agreement = model.decode_body(
                params, cache, x["tokens"], x["lengths"], x["prev_accept"], tree=plan, pages=x.get("pages"),
                commit=(x["dst"], x["src"]) if branchy else None, telemetry=telemetry)
            ids = torch.argmax(logits, dim=-1)
            return (logits, ids) if agreement is None else (logits, ids, agreement)

        self.launcher = CompiledLaunch(body, inputs, [params, cache], model.device, graphs)
        if self.launcher.cuda:
            self._ids = torch.zeros((batch, Tn), dtype=torch.int64, pin_memory=True)
            self._agreement = torch.zeros((), dtype=torch.float32, pin_memory=True)

    @property
    def logits(self) -> torch.Tensor:
        """The last call's logits (B, T, V), on the model's device (on the
        card the graph's static output, overwritten by the next call)."""
        return self.launcher.outputs[0]

    def launch(self, tokens, lengths, prev_accept=None, *, pages=None, commit=None) -> Tuple[torch.Tensor, ...]:
        """Check and stage the inputs, run the launch; returns its device
        outputs (logits, ids[, agreement]) and reads nothing back."""
        tokens, lengths, prev, _, pages, commit = self.model.decode_inputs(
            self.cache, tokens, lengths, prev_accept, tree=self.tree, pages=pages, commit=commit,
            max_len=self.max_len)
        arrays = {"tokens": tokens, "lengths": lengths, "prev_accept": prev}
        if pages is not None:
            arrays["pages"] = pages
        if self.branchy:
            if commit is None:
                raise ValueError("a branchy paged step takes the commit maps (dst, src) at every launch")
            arrays["dst"], arrays["src"] = commit
        elif commit is not None:
            raise ValueError(f"a {self.plane} step takes no commit maps")
        if self.recorder is not None:
            kw = {"pages": None if pages is None else pages.copy(),
                  "commit": None if commit is None else tuple(m.copy() for m in commit)}
            self.recorder.append((tokens.copy(), lengths.copy(), prev.copy(), kw))
        return self.launcher(arrays)

    def __call__(self, tokens, lengths, prev_accept=None, *, pages=None,
                 commit=None) -> Tuple[np.ndarray, Optional[float]]:
        out = self.launch(tokens, lengths, prev_accept, pages=pages, commit=commit)
        agreement = out[2] if len(out) > 2 else None
        if self.launcher.cuda:
            self._ids.copy_(out[1], non_blocking=True)
            if agreement is not None:
                self._agreement.copy_(agreement, non_blocking=True)
                agreement = self._agreement
            torch.cuda.current_stream(self.launcher.device).synchronize()
            ids = self._ids.numpy().copy()
        else:
            ids = out[1].numpy()
        return ids, (self.model.plan_agreement(agreement) if self.telemetry else None)


def build_spec_serve_step(model: Model, params: Params, cache: List[Params], *, batch: int,
                          tree: Optional[TreePlan] = None, telemetry: bool = False, max_len: Optional[int] = None,
                          graphs: Optional[GraphPool] = None) -> _SpecServeStep:
    """The compiled decode launch bound to one replica's ``params`` and
    ``cache`` (:class:`_SpecServeStep`); ``max_len`` is the slot budget
    positions are checked against (and, paged, sets the block table's
    width); ``graphs`` is the replica's shared pool, a new one if None."""
    return _SpecServeStep(model, params, cache, batch=batch, tree=tree, telemetry=telemetry, max_len=max_len,
                          graphs=graphs)


class TreeCommit:
    """:meth:`Model.commit_tree_path` on a contiguous cache, compiled for
    (B, T) (:class:`CompiledLaunch`): static lengths (B,) and path (B, T)
    buffers, one graph."""

    def __init__(self, cache: List[Params], *, batch: int, T: int, graphs: Optional[GraphPool] = None):
        def body(x):
            Model.commit_rows(cache, x["lengths"], x["path"])
            return ()

        self.launcher = CompiledLaunch(body, {"lengths": ((batch,), torch.int64), "path": ((batch, T), torch.int64)},
                                      cache, cache[0]["k"].device, graphs)

    def __call__(self, lengths, path) -> None:
        self.launcher({"lengths": np.asarray(lengths, np.int64), "path": np.asarray(path, np.int64)})
