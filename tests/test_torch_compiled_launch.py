"""PyTorch port, the compiled decode launch (``launch/steps.py``) on the CPU,
where it runs its device body eagerly on its static buffers.

Gates: the step object is bitwise ``Model.decode_tokens`` over successive
launches whose lengths, prev_accept, block tables and commit maps change
between launches (a stale static buffer would show), on every plane and
family, and the compiled contiguous tree commit is bitwise
``Model.commit_tree_path``; a compiled ``ServeReplica`` serves the
reference's streams; the drafter's device top-k is ``np.argsort(-logits)``
on untied rows and breaks ties by the lower index; a capture's recorded
launch counts, added at replay, equal an eager launch's; a replaced cache
or parameter leaf raises; the cached rotary frequencies are bitwise the
formula's; the step holds every cached device constant its body reads
(a graph keeps their addresses), so clearing the caches frees none;
deleting a replica frees its compiled launches; a reset replica serves
as a new one; the step's recorder keeps each call's inputs.
"""
from __future__ import annotations

import dataclasses
import gc
import inspect
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.launch.serve import ServeReplica as JReplica
from repro.models.model import Model as JModel
from repro.runtime.fabric import Request as JRequest
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.control_plane import _top_k
from repro_torch.core.plans import TreePlan
from repro_torch.kernels import add_launch_counts, count_launch, launch_counts, recorded_launches, reset_launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.moe_decode import ops as md_ops
from repro_torch.kernels.moe_decode import ref as md_ref
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import TreeCommit, build_spec_serve_step
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from _torch_decode_cases import B, CASES, LAUNCHES, MAX_LEN, MOE, admitted, case, clone, inputs, root_paths


@pytest.mark.parametrize("name", list(CASES))
def test_step_is_bitwise_decode_tokens(name):
    cfg, tree, telemetry = case(name)
    model, params, cache = admitted(cfg, "cpu")
    eager = clone(cache)
    step = build_spec_serve_step(model, params, cache, batch=B, tree=tree, telemetry=telemetry, max_len=MAX_LEN)
    assert step.key == (B, tree.num_nodes if tree else cfg.spec_tokens, tree, step.plane, telemetry)
    commit = TreeCommit(cache, batch=B, T=tree.num_nodes) if tree and not cfg.paged else None
    rng = np.random.default_rng(1)
    for _ in range(LAUNCHES):
        tokens, lengths, prev, kw = inputs(cfg, tree, rng)
        want = model.decode_tokens(params, eager, tokens, lengths, prev, tree=tree, telemetry=telemetry,
                                   max_len=MAX_LEN, **kw)
        want, metrics = want if telemetry else (want, None)
        ids, agreement = step(tokens, lengths, prev, **kw)
        assert torch.equal(step.logits, want)
        np.testing.assert_array_equal(ids, want.argmax(-1).numpy())
        assert agreement == (metrics["plan_agreement"] if telemetry else None)
        if commit is not None:
            path = root_paths(tree, rng)
            Model.commit_tree_path(eager, lengths, path)
            commit(lengths, path)
    for i, (a, b) in enumerate(zip(cache, eager)):
        for leaf in a:
            assert torch.equal(a[leaf], b[leaf]), (i, leaf)


@pytest.mark.parametrize("name", ["tree", "paged tree", "chain"])
def test_step_refuses_inputs_of_another_shape_or_plane(name):
    cfg, tree, _ = case(name)
    model, params, cache = admitted(cfg, "cpu")
    step = build_spec_serve_step(model, params, cache, batch=B, tree=tree, max_len=MAX_LEN)
    tokens, lengths, prev, kw = inputs(cfg, tree, np.random.default_rng(2))
    with pytest.raises(ValueError, match="launch built for"):
        step(np.concatenate([tokens, tokens]), np.concatenate([lengths, lengths]), np.concatenate([prev, prev]),
             **{k: (np.concatenate([v, v]) if k == "pages" else tuple(np.concatenate([m, m]) for m in v))
                for k, v in kw.items()})
    if step.branchy:
        with pytest.raises(ValueError, match="commit maps"):
            step(tokens, lengths, prev, pages=kw["pages"])
    else:
        with pytest.raises(ValueError, match="takes no commit maps"):
            step(tokens, lengths, prev, commit=(tokens, tokens), **kw)


def _host_mesh():
    """A (1, 1) mesh with Auto axes (see ``test_torch_serve.py``)."""
    from jax.sharding import AxisType

    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


def _shard_map_accepting_check_rep(f, **kw):
    """The reference passes ``check_rep``, which this jax renamed ``check_vma``."""
    if "check_rep" in kw:
        kw["check_vma"] = kw.pop("check_rep")
    return jax.shard_map(f, **kw)


SERVE_SLOTS, SERVE_PROMPT, SERVE_GEN, SERVE_REQ = 2, 8, 6, 4
SERVE = {"spec 4 ngram": (4, None, "ngram"), "tree 2,2 model drafter": (5, (2, 2), "model")}
_REFERENCE = {}


def _reference(name):
    if name not in _REFERENCE:
        Tn, branching, _ = SERVE[name]
        cfg = dataclasses.replace(j_smoke(MOE), decode_plane=True, spec_tokens=Tn)
        params = JModel(cfg).init(jax.random.PRNGKey(0))
        kw = {}
        if branching:
            from repro.core.plans import TreePlan as JTree

            kw["tree"] = JTree(TreePlan.from_branching(branching).parents)
        rep = JReplica(cfg, _host_mesh(), SERVE_SLOTS, SERVE_PROMPT + SERVE_GEN + Tn, params, **kw)
        queue, out = tserve.synthetic_requests(cfg.vocab_size, SERVE_PROMPT, SERVE_GEN, SERVE_REQ), {}
        while queue or rep.has_work():
            while queue and rep.free_slots():
                r = queue.pop(0)
                rep.admit(JRequest(rid=r.rid, prompt=r.prompt, gen=r.gen))
            for res in rep.step():
                out[res.rid] = res.tokens
        names, leaves, _ = _flatten(params)
        _REFERENCE[name] = (out, {n: np.asarray(l) for n, l in zip(names, leaves)})
    return _REFERENCE[name]


@pytest.mark.parametrize("name", list(SERVE))
def test_compiled_replica_serves_the_reference_streams(name, monkeypatch):
    import repro.parallel.moe_parallel as moe_parallel

    if "check_rep" not in inspect.signature(moe_parallel.shard_map).parameters:
        monkeypatch.setattr(moe_parallel, "shard_map", _shard_map_accepting_check_rep)
    want, arrays = _reference(name)
    Tn, branching, drafter = SERVE[name]
    cfg = dataclasses.replace(t_smoke(MOE), decode_plane=True, spec_tokens=Tn)
    params = params_from_numpy(cfg, arrays, "cpu")
    tree = TreePlan.from_branching(branching) if branching else None
    rep = tserve.ServeReplica(cfg, SERVE_SLOTS, SERVE_PROMPT + SERVE_GEN + Tn, params, tree=tree, drafter=drafter,
                              device="cpu")
    got = tserve.serve_queue(rep, tserve.synthetic_requests(cfg.vocab_size, SERVE_PROMPT, SERVE_GEN, SERVE_REQ))
    assert {rid: r.tokens for rid, r in got.items()} == want
    assert rep._decode.launcher.graph is None  # the CPU runs the body eagerly
    if tree is not None:
        assert rep.commits == rep.launches and isinstance(rep._commit, TreeCommit)
        assert rep.model_drafter is not None and rep.model_drafter.launches > 0


@pytest.mark.parametrize("k", [1, 2, 3])
def test_device_top_k_is_argsort_on_untied_rows(k):
    logits = np.random.default_rng(k).standard_normal((4, 1000)).astype(np.float32)
    got = _top_k(torch.from_numpy(logits), k)[1].numpy()
    np.testing.assert_array_equal(got, np.argsort(-logits, axis=-1)[:, :k])


def test_device_top_k_breaks_ties_by_the_lower_index():
    logits = np.zeros((3, 50), np.float32)
    logits[0, [7, 3, 40]] = 2.0                 # a tie for the top three
    logits[1, [9, 30]] = 1.0
    logits[1, 20] = 5.0                          # a tie past the top one, at the boundary
    logits[2, :] = -1.0                          # all tied
    got = _top_k(torch.from_numpy(logits), 3)[1].numpy()
    np.testing.assert_array_equal(got, [[3, 7, 40], [20, 9, 30], [0, 1, 2]])


def _counting_plain_versions(monkeypatch):
    """On the CPU the wrappers run their plain versions and count nothing:
    count there as the card's launches do."""
    for module, fn, wrapper, scales_at in ((fa_ref, "flash_decode", fa_ops.flash_decode_kernel, 6),
                                           (fa_ref, "flash_decode_paged", fa_ops.flash_decode_paged_kernel, 8),
                                           (md_ref, "decode_moe", md_ops.decode_moe_kernel, 6)):
        plain = getattr(module, fn)

        def counted(*args, _plain=plain, _wrapper=wrapper, _at=scales_at):
            count_launch(_wrapper, int8=len(args) > _at and args[_at] is not None)
            return _plain(*args)

        monkeypatch.setattr(module, fn, counted)


@pytest.mark.parametrize("name", ["chain", "paged tree", "int8"])
def test_recorded_launch_counts_equal_an_eager_launch(name, monkeypatch):
    _counting_plain_versions(monkeypatch)
    cfg, tree, telemetry = case(name)
    model, params, cache = admitted(cfg, "cpu")
    step = build_spec_serve_step(model, params, clone(cache), batch=B, tree=tree, telemetry=telemetry,
                                 max_len=MAX_LEN)
    tokens, lengths, prev, kw = inputs(cfg, tree, np.random.default_rng(3))
    reset_launch_counts()
    model.decode_tokens(params, cache, tokens, lengths, prev, tree=tree, max_len=MAX_LEN, **kw)
    eager = {n: c for n, c in launch_counts().items() if c}
    assert eager and all(c == cfg.num_layers for c in eager.values())
    assert any(n.endswith("_int8") for n in eager) == (name == "int8")
    step(tokens, lengths, prev, **kw)  # fills the static buffers
    reset_launch_counts()
    launcher = step.launcher
    with recorded_launches() as taken:  # the step's capture path: counted, then taken back out
        launcher._body(launcher.inputs)
    assert taken == eager and not any(launch_counts().values())
    for replay in range(1, 3):
        add_launch_counts(taken)
        assert {n: c for n, c in launch_counts().items() if c} == {n: replay * c for n, c in eager.items()}


@pytest.mark.parametrize("what", ["cache", "params"])
def test_a_replaced_leaf_raises(what):
    cfg, tree, _ = case("chain")
    model, params, cache = admitted(cfg, "cpu")
    step = build_spec_serve_step(model, params, cache, batch=B, max_len=MAX_LEN)
    tokens, lengths, prev, _ = inputs(cfg, tree, np.random.default_rng(4))
    step(tokens, lengths, prev)
    Model.write_cache_slot(cache, [{n: t[:1].clone() for n, t in c.items()} for c in cache], 1)  # in place: fine
    step(tokens, lengths, prev)
    if what == "cache":
        cache[1]["v"] = cache[1]["v"].clone()
    else:
        params["layers"][0]["attn"]["wq"] = params["layers"][0]["attn"]["wq"].clone()
    with pytest.raises(RuntimeError, match="replaced instead of written in place"):
        step(tokens, lengths, prev)


def test_cached_rope_frequencies_are_the_formula_bitwise():
    for hd, theta in ((16, 10000.0), (64, 1e6), (128, 10000), (256, 1e4)):
        exps = torch.arange(0, hd, 2, dtype=torch.float32) / hd
        want = 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exps)
        got = L.rope_frequencies(hd, theta, torch.device("cpu"))
        assert torch.equal(got, want) and got.dtype == torch.float32
        assert L.rope_frequencies(hd, theta, torch.device("cpu")) is got  # made once


def test_deleting_a_replica_frees_its_compiled_launches():
    cfg = dataclasses.replace(t_smoke(MOE), decode_plane=True, spec_tokens=5)
    params = Model(cfg, device="cpu").init(0)
    rep = tserve.ServeReplica(cfg, 2, 24, params, tree=TreePlan.from_branching((2, 2)), drafter="model",
                              device="cpu")
    tserve.serve_queue(rep, tserve.synthetic_requests(cfg.vocab_size, 8, 3, 2))
    refs = [weakref.ref(o) for o in (rep._decode, rep._commit, rep.model_drafter._step, rep.cache[0]["k"])]
    gc.disable()  # freed by reference counting alone: no cycle holds a launch
    try:
        del rep
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("name", ["tree", "paged tree", "int8", "hybrid"])
def test_step_holds_the_cached_constants_it_reads(name, monkeypatch):
    cfg, tree, _ = case(name)
    model, params, cache = admitted(cfg, "cpu")
    eager = clone(cache)
    step = build_spec_serve_step(model, params, cache, batch=B, tree=tree, max_len=MAX_LEN)
    made, read = (L.rope_frequencies, T._tree_tensors), []

    def spy(fn):
        def get(*args):
            out = fn(*args)
            read.extend(out if isinstance(out, tuple) else (out,))
            return out
        return get

    monkeypatch.setattr(L, "rope_frequencies", spy(made[0]))
    monkeypatch.setattr(T, "_tree_tensors", spy(made[1]))
    rng = np.random.default_rng(7)
    for launch in range(2):
        tokens, lengths, prev, kw = inputs(cfg, tree, rng)
        want = model.decode_tokens(params, eager, tokens, lengths, prev, tree=tree, max_len=MAX_LEN, **kw)
        read.clear()
        step(tokens, lengths, prev, **kw)
        assert torch.equal(step.logits, want), launch
        # every cached tensor the body read is one the step holds
        assert read and all(any(t is h for h in step._constants) for t in read)
        kept = [weakref.ref(t) for t in read]
        read.clear()
        for fn in made:
            fn.cache_clear()
        gc.collect()
        assert all(r() is not None for r in kept)  # the caches let go; the step keeps them alive


@pytest.mark.parametrize("paged", [False, True])
def test_a_reset_replica_serves_as_a_new_one(paged):
    cfg = dataclasses.replace(t_smoke(MOE), decode_plane=True, spec_tokens=4, paged=paged, page_size=8)
    params = Model(cfg, device="cpu").init(0)
    tree = TreePlan.from_branching((2, 1))

    def replica():
        return tserve.ServeReplica(cfg, 2, 24, params, tree=tree, drafter="model", device="cpu")

    def queue(n=3, gen=4):
        return tserve.synthetic_requests(cfg.vocab_size, 8, gen, n, shared_prefix=8)

    def stats(r):
        out = {n: getattr(r, n) for n in ("launches", "prefills", "commits", "commit_moves", "accepted_total",
                                           "drafted_total")}
        out["drafter_launches"] = r.model_drafter.launches
        return dict(out, **(r.paged_stats() if paged else {}))

    fresh = replica()
    want = tserve.serve_queue(fresh, queue())
    rep = replica()
    tserve.serve_queue(rep, queue(1, 2))  # a warm-up, then the replica reset
    rep.reset()
    got = tserve.serve_queue(rep, queue())
    assert {i: r.tokens for i, r in got.items()} == {i: r.tokens for i, r in want.items()}
    assert stats(rep) == stats(fresh)
    rep.admit(queue(1)[0])
    with pytest.raises(RuntimeError, match="still serves requests"):
        rep.reset()


def test_the_recorder_keeps_each_calls_inputs():
    cfg, tree, _ = case("paged tree")
    model, params, cache = admitted(cfg, "cpu")
    eager = clone(cache)
    step = build_spec_serve_step(model, params, cache, batch=B, tree=tree, max_len=MAX_LEN)
    step.recorder, rng, outs = [], np.random.default_rng(8), []
    calls = [inputs(cfg, tree, rng) for _ in range(3)]
    for tokens, lengths, prev, kw in calls:
        step(tokens, lengths, prev, **kw)
        outs.append(step.logits.clone())
        tokens[:] = 0  # the caller's arrays change after the call; the record does not
    recorded, step.recorder = step.recorder, None
    step(*calls[0][:3], **calls[0][3])
    assert len(recorded) == len(calls)
    for (tokens, lengths, prev, kw), want in zip(recorded, outs):
        got = model.decode_tokens(params, eager, tokens, lengths, prev, tree=tree, max_len=MAX_LEN, **kw)
        assert torch.equal(got, want)
