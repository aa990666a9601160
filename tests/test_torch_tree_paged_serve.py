"""PyTorch port, serving with draft trees and the paged KV plane: the port's
``ServeReplica`` against the reference's on the same synthetic queue with
bridged weights.

Gates: per-request streams IDENTICAL for a contiguous tree ``2,2`` (ngram
drafter, and the port's model drafter: verify makes every stream the
target's greedy stream), a paged tree ``2,1`` with page size 8, and a paged
chain of 3 behind a 16-token shared system prompt; for the paged runs the
block tables, refcounts and trie (``pager.snapshot()``, ``trie.snapshot()``),
``pages_shared_total`` and ``admit_copy_rows`` are identical too.
``ModelDrafter.propose`` equals the reference's on bridged drafter weights.
"""
from __future__ import annotations

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.manager import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.core.plans import TreePlan as JTree
from repro.launch.serve import ServeReplica as JReplica
from repro.launch.speculative import ModelDrafter as JDrafter
from repro.models.model import Model as JModel
from repro.runtime.fabric import Request as JRequest
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.plans import TreePlan
from repro_torch.launch import serve as tserve
from repro_torch.launch.speculative import ModelDrafter
from repro_torch.models.model import Model as TModel

ARCH = "qwen3-moe-235b-a22b"
SLOTS, PROMPT, GEN, N_REQ = 2, 8, 6, 4

# name -> (tree branching or None, spec width, paged, page size, shared prefix)
CASES = {
    "tree 2,2": ((2, 2), 0, False, 16, 0),
    "paged tree 2,1 ps 8": ((2, 1), 0, True, 8, 0),
    "paged spec 3 shared 16": (None, 3, True, 16, 16),
}


def _host_mesh():
    """A (1, 1) mesh with Auto axes (see ``test_torch_serve.py``)."""
    from jax.sharding import AxisType

    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))


def _shard_map_accepting_check_rep(f, **kw):
    """The reference passes ``check_rep``, which this jax renamed ``check_vma``."""
    if "check_rep" in kw:
        kw["check_vma"] = kw.pop("check_rep")
    return jax.shard_map(f, **kw)


@pytest.fixture(autouse=True)
def _check_rep_shim(monkeypatch):
    import repro.parallel.moe_parallel as moe_parallel

    if "check_rep" not in inspect.signature(moe_parallel.shard_map).parameters:
        monkeypatch.setattr(moe_parallel, "shard_map", _shard_map_accepting_check_rep)


def _setup(name):
    branching, spec, paged, ps, shared = CASES[name]
    tree = TreePlan.from_branching(branching) if branching else None
    Tn = tree.num_nodes if tree else spec
    kw = dict(decode_plane=True, spec_tokens=Tn, paged=paged, page_size=ps)
    max_len = PROMPT + shared + GEN + Tn
    reqs = tserve.synthetic_requests(256, PROMPT, GEN, N_REQ, shared)
    return tree, kw, max_len, reqs


_REF = {}


def _reference(name):
    """The reference replica served over the queue (once per case), its
    streams, and its weights as numpy leaves."""
    if name not in _REF:
        tree, kw, max_len, reqs = _setup(name)
        cfg = dataclasses.replace(j_smoke(ARCH), **kw)
        params = JModel(cfg).init(jax.random.PRNGKey(0))
        rep = JReplica(cfg, _host_mesh(), SLOTS, max_len, params,
                       tree=JTree(tree.parents) if tree else None, drafter="ngram")
        queue, out = list(reqs), {}
        while queue or rep.has_work():
            while queue and rep.free_slots():
                r = queue.pop(0)
                rep.admit(JRequest(rid=r.rid, prompt=r.prompt, gen=r.gen))
            for res in rep.step():
                out[res.rid] = res.tokens
        names, leaves, _ = _flatten(params)
        _REF[name] = (out, rep, {n: np.asarray(l) for n, l in zip(names, leaves)})
    return _REF[name]


def _serve_port(name, drafter="ngram"):
    tree, kw, max_len, reqs = _setup(name)
    want, jrep, arrays = _reference(name)
    cfg = dataclasses.replace(t_smoke(ARCH), **kw)
    rep = tserve.ServeReplica(cfg, SLOTS, max_len, params_from_numpy(cfg, arrays, "cpu"), tree=tree,
                              drafter=drafter, device="cpu")
    got = tserve.serve_queue(rep, reqs)
    return {rid: r.tokens for rid, r in got.items()}, want, rep, jrep


@pytest.mark.parametrize("name", sorted(CASES))
def test_tree_and_paged_serve_streams_match_reference(name):
    got, want, rep, jrep = _serve_port(name)
    assert got == want
    assert all(len(t) == GEN + 1 for t in want.values())
    if rep.paged:
        assert rep.pager.snapshot() == jrep.pager.snapshot()
        assert rep.trie.snapshot() == jrep.trie.snapshot()
        assert rep.pages_shared_total == jrep.pages_shared_total
        assert rep.admit_copy_rows == jrep.admit_copy_rows
        assert rep.commits == 0
        assert (rep.pages_shared_total > 0) == (CASES[name][4] > 0)
    if rep.tree is not None:
        assert rep.accepted_total > rep.launches  # some draft past the root was accepted
        assert rep.commits == (0 if rep.paged else rep.launches)


def test_model_drafter_serves_the_target_greedy_stream():
    got, want, rep, _ = _serve_port("tree 2,2", drafter="model")
    assert got == want and rep.model_drafter is not None


def test_model_drafter_proposes_as_the_reference():
    cfg_kw = dict(decode_plane=True, num_layers=1, spec_tokens=1, paged=False)
    jcfg = dataclasses.replace(j_smoke(ARCH), **cfg_kw)
    tcfg = dataclasses.replace(t_smoke(ARCH), **cfg_kw)
    jp = JModel(jcfg).init(jax.random.PRNGKey(7))
    names, leaves, _ = _flatten(jp)
    tp = params_from_numpy(tcfg, {n: np.asarray(l) for n, l in zip(names, leaves)}, "cpu")
    jd = JDrafter(JModel(jcfg), jp, 2, 32)
    td = ModelDrafter(TModel(tcfg, device="cpu"), tp, 2, 32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 6)]
    for b, p in enumerate(prompts):
        jd.admit(b, jnp.asarray(p))
        td.admit(b, p)
    seen = [rng.integers(0, 256, n).tolist() for n in (3, 1)]
    for b, s in enumerate(seen):
        jd.observe(b, s)
        td.observe(b, s)
    jd.catch_up()
    td.catch_up()
    np.testing.assert_array_equal(td.fed, jd.fed)
    tree = TreePlan.from_branching((3, 2, 1))
    last = np.asarray([5, 77], np.int32)
    lengths = td.fed.copy()
    want = jd.propose(last, lengths, JTree(tree.parents))
    got = td.propose(last, lengths, tree)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shared,code", [(16, 0), (0, 1)])
def test_cli_expect_shared_pages(shared, code, capsys):
    rc = tserve.main([
        "--arch", ARCH, "--smoke", "--decode-plane", "--paged", "--spec-tokens", "3", "--slots", "2",
        "--prompt-len", "8", "--gen", "3", "--requests", "3", "--shared-prefix", str(shared),
        "--expect-shared-pages", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert rc == code, out
    assert "pages bound via prefix trie" in out
