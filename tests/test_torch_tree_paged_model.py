"""PyTorch port, model: draft trees and the paged KV plane against the JAX
reference's jnp paths (``use_pallas=False``), on the CPU, with the
reference's weights bridged through numpy.

Config: the smoke config with 16 experts top-2, so the plan rows each node
consumes (selected by its parent) are not vacuous.  Gates: logits within
1e-5 and K/V rows within 1e-5 (f32; the two sides sum in different
orders), plan ids EXACTLY equal, greedy tokens identical, after every launch
of a served sequence with greedy verify: a contiguous tree ``(2, 2)``
committed by ``commit_tree_path``, a paged chain of 3 and a paged tree
``(2, 1)`` committed by fused commit maps, both through a scrambled block
table.  The paged chain on ``paginate_cache`` with the identity table is
bitwise the contiguous chain.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.core.pages import commit_maps as j_commit_maps
from repro.core.plans import TreePlan as JTree
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.pages import commit_maps
from repro_torch.core.plans import TreePlan
from repro_torch.launch.speculative import draft_tree_ngram, greedy_accept_tree
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel

ARCH = "qwen3-moe-235b-a22b"
TOL = 1e-5
B, S, LAUNCHES = 2, 11, 5
VARIANT = dict(num_experts=16, top_k=2)


def _configs(Tn, **kw):
    kw = dict(decode_plane=True, spec_tokens=Tn, **VARIANT, **kw)
    return dataclasses.replace(j_smoke(ARCH), **kw), dataclasses.replace(t_smoke(ARCH), **kw)


_PARAMS = {}


def _params(jcfg, tcfg):
    """Reference weights (drawn once) and their bridge into the port."""
    if "j" not in _PARAMS:
        jp = JModel(dataclasses.replace(jcfg, paged=False, spec_tokens=1)).init(jax.random.PRNGKey(0))
        names, leaves, _ = _flatten(jp)
        _PARAMS["j"] = jp
        _PARAMS["np"] = {n: np.asarray(l) for n, l in zip(names, leaves)}
    return _PARAMS["j"], params_from_numpy(tcfg, _PARAMS["np"], "cpu")


def _prompts(vocab):
    return np.random.default_rng(1).integers(0, vocab, (B, S)).astype(np.int32)


def _scrambled_table(mp, n_pages, seed=3):
    """Each slot's pages drawn from a permutation of the pool; the logical
    pages past ``mp - 1`` stay unallocated only in tests that say so."""
    perm = np.random.default_rng(seed).permutation(n_pages)[: B * mp]
    return perm.reshape(B, mp).astype(np.int32)


def _rows_for(table, b, L, max_len, ps, R):
    rows = np.full((max_len,), R, np.int32)
    for pos in range(L):
        rows[pos] = table[b, pos // ps] * ps + pos % ps
    return rows


def _j_pool(jc, name):
    return np.asarray(jc["scan"]["b0"][name])  # (layers, R, nkv, hd) or (layers, B, ...)


def _t_stack(tc, name):
    return np.stack([c[name].numpy() for c in tc])


def _serve(jcfg, tcfg, tree, *, paged):
    """Prefill both sides, then LAUNCHES greedy launches with verify and
    commit, holding logits, KV and plan rows after each launch."""
    Tn = tree.num_nodes
    jp, tp = _params(jcfg, tcfg)
    ps = tcfg.page_size
    max_len = S + LAUNCHES * Tn + Tn
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    prompts = _prompts(jcfg.vocab_size)
    if paged:
        mp = TT.max_pages_for(tcfg, max_len)
        R = TT.num_pages(tcfg, B, max_len) * ps
        table = _scrambled_table(mp, R // ps)
        jpf = JModel(dataclasses.replace(jcfg, paged=False))
        tpf = TModel(dataclasses.replace(tcfg, paged=False), device="cpu")
        jc, tc = jm.init_cache(B, max_len), tm.init_cache(B, max_len)
        jlast, tlast = [], []
        for b in range(B):
            rows = _rows_for(table, b, S, max_len, ps, R)
            jl1, one = jax.jit(jpf.prefill)(jp, jnp.asarray(prompts[b:b + 1]), jpf.init_cache(1, max_len))
            jc = jm.write_cache_slot_paged(jc, one, b, jnp.asarray(rows))
            tone = tpf.init_cache(1, max_len)
            tl1 = tpf.prefill(tp, prompts[b:b + 1], tone)
            tm.write_cache_slot_paged(tc, tone, b, rows)
            jlast.append(np.asarray(jl1)[0])
            tlast.append(tl1[0].numpy())
        jl, tl = np.stack(jlast), np.stack(tlast)
    else:
        table = R = None
        jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jm.init_cache(B, max_len))
        tc = tm.init_cache(B, max_len)
        tl = tm.prefill(tp, prompts, tc).numpy()
        jl = np.asarray(jl)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)

    jtree = JTree(tree.parents)
    jdec = jax.jit(jm.decode_tokens, static_argnames=("telemetry", "tree"))
    branchy = not tree.is_chain()
    last = jl.argmax(-1).astype(np.int32)
    history = [[int(t)] for t in last]
    lengths = np.full((B,), S, np.int32)
    prev = np.zeros((B,), np.int32)
    commit = None
    accepts = []
    # slot 0 drafts from its own sequential greedy stream: on even launches
    # along the spine, on odd ones the right token sits on the root's LAST
    # child (a sibling), so the accepted path leaves the spine and its rows
    # must move; slot 1 drafts with the ngram drafter
    oracle = _sequential_stream(tcfg, tp, prompts[0], LAUNCHES * Tn + 1, int(last[0]))
    kids = tree.children()
    for step in range(LAUNCHES):
        toks = np.stack([draft_tree_ngram(history[b], int(last[b]), tree) for b in range(B)]).astype(np.int32)
        n0 = len(history[0]) - 1
        if step % 2 == 0 or len(kids[0]) < 2:
            for depth, node in enumerate(tree.spine()[1:], start=1):
                toks[0, node] = oracle[n0 + depth]
        else:
            toks[0, kids[0][0]] = (oracle[n0 + 1] + 1) % jcfg.vocab_size
            toks[0, kids[0][-1]] = oracle[n0 + 1]
        kw = dict(tree=jtree if branchy else None, telemetry=True)
        tkw = dict(tree=tree if branchy else None, telemetry=True)
        if paged:
            kw["pages"] = jnp.asarray(table)
            tkw["pages"] = table
            if branchy:
                c = commit if commit is not None else (np.full((B, Tn), -1, np.int32),) * 2
                kw["commit"] = tuple(jnp.asarray(m) for m in c)
                tkw["commit"] = c
        jlg, jc, jmet = jdec(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(prev), **kw)
        tlg, tmet = tm.decode_tokens(tp, tc, toks, lengths, prev, **tkw)
        msg = f"launch {step}"
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL, err_msg=msg)
        assert abs(tmet["plan_agreement"] - float(jmet["plan_agreement"])) <= TOL, msg
        np.testing.assert_array_equal(_t_stack(tc, "plan_e"), _j_pool(jc, "plan_e"), err_msg=msg)
        for name in (("pk", "pv") if paged else ("k", "v")):
            got = _t_stack(tc, name)
            got = got[:, :R] if paged else got  # the port's trash row is not the reference's
            np.testing.assert_allclose(got, _j_pool(jc, name), atol=TOL, rtol=TOL, err_msg=f"{msg} {name}")
        y = np.asarray(jnp.argmax(jlg, -1))
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), y, err_msg=msg)
        path_pad = np.tile(np.arange(Tn, dtype=np.int32), (B, 1))
        acc = np.zeros((B,), np.int32)
        for b in range(B):
            path = greedy_accept_tree(toks[b], y[b], tree, 99)
            path_pad[b, : len(path)] = path
            acc[b] = len(path)
            history[b].extend(int(y[b, p]) for p in path)
            prev[b] = path[-1]
            last[b] = y[b, path[-1]]
        accepts.extend(acc.tolist())
        if branchy and paged:
            commit = commit_maps(lengths, path_pad, acc, Tn)
            for a, want in zip(commit, j_commit_maps(lengths, path_pad, acc, Tn)):
                np.testing.assert_array_equal(a, want)
        elif branchy:
            jc = jm.commit_tree_path(jc, jnp.asarray(lengths), jnp.asarray(path_pad))
            tm.commit_tree_path(tc, lengths, path_pad)
            for name in ("k", "v"):
                np.testing.assert_allclose(_t_stack(tc, name), _j_pool(jc, name), atol=TOL, rtol=TOL)
        lengths += acc
        if branchy:
            assert history[0] == oracle[: len(history[0])], msg  # slot 0 kept its sequential stream
    return accepts


def _sequential_stream(tcfg, tp, prompt, n, first):
    """Greedy stream of one prompt at width 1 (the port's own sequential decode)."""
    m = TModel(dataclasses.replace(tcfg, spec_tokens=1, paged=False), device="cpu")
    cache = m.init_cache(1, len(prompt) + n + 1)
    m.prefill(tp, prompt[None], cache)
    out = [first]
    for i in range(n):
        lg = m.decode_tokens(tp, cache, [[out[-1]]], [len(prompt) + i])
        out.append(int(lg[0, 0].argmax()))
    return out


@pytest.mark.parametrize(
    "case,Tn,tree,paged,ps",
    [
        ("contiguous tree 2,2", 5, TreePlan.from_branching((2, 2)), False, 16),
        ("paged chain", 3, TreePlan.chain(3), True, 8),
        ("paged tree 2,1", 4, TreePlan.from_branching((2, 1)), True, 8),
    ],
)
def test_tree_and_paged_decode_match_reference(case, Tn, tree, paged, ps):
    jcfg, tcfg = _configs(Tn, paged=paged, page_size=ps)
    accepts = _serve(jcfg, tcfg, tree, paged=paged)
    assert max(accepts) == len(tree.spine()), accepts  # a whole spine was accepted
    assert min(accepts) == 1, accepts                   # and a whole draft rejected


def test_paged_chain_on_identity_table_is_bitwise_the_contiguous_chain():
    Tn = 4
    _, ccfg = _configs(Tn)
    pcfg = dataclasses.replace(ccfg, paged=True, page_size=8)
    _, tp = _params(*_configs(Tn))
    max_len = S + 3 * Tn + 5  # not a page multiple: paginate pads
    cm, pm = TModel(ccfg, device="cpu"), TModel(pcfg, device="cpu")
    prompts = _prompts(ccfg.vocab_size)
    cc = cm.init_cache(B, max_len)
    cm.prefill(tp, prompts, cc)
    pc = pm.paginate_cache(cc, max_len)
    table = TT.identity_page_table(pcfg, B, max_len)
    lengths = np.asarray([S, S - 3], np.int32)
    rng = np.random.default_rng(5)
    for step in range(3):
        toks = rng.integers(0, ccfg.vocab_size, (B, Tn)).astype(np.int32)
        prev = np.asarray([step % Tn, 0], np.int32)
        want = cm.decode_tokens(tp, cc, toks, lengths, prev)
        got = pm.decode_tokens(tp, pc, toks, lengths, prev, pages=table)
        assert torch.equal(got, want), step
        lengths += 1 + step
    mp = TT.max_pages_for(pcfg, max_len)
    for c, p in zip(cc, pc):
        pool = p["pk"][:-1].view(B, mp * pcfg.page_size, *p["pk"].shape[1:])
        assert torch.equal(pool[:, :max_len], c["k"])
        assert torch.equal(p["plan_e"], c["plan_e"])


@pytest.mark.parametrize("branching", [(1, 1, 1), (2, 2), (3, 1, 2)])
def test_tree_plan_tables_match_reference(branching):
    tree, jtree = TreePlan.from_branching(branching), JTree.from_branching(branching)
    assert tree.parents == jtree.parents and tree.spine() == jtree.spine()
    assert tree.depths() == jtree.depths() and tree.ancestor_words() == jtree.ancestor_words()


def test_commit_tree_path_and_cow_copy_page_match_reference():
    Tn = 5
    jcfg, tcfg = _configs(Tn)
    max_len = 24
    rng = np.random.default_rng(2)
    jc = JModel(jcfg).init_cache(B, max_len)
    tc = TModel(tcfg, device="cpu").init_cache(B, max_len)
    k = rng.standard_normal(_j_pool(jc, "k").shape).astype(np.float32)
    jc["scan"]["b0"]["k"] = jnp.asarray(k)
    for i, c in enumerate(tc):
        c["k"].copy_(torch.from_numpy(k[i]))
    lengths = np.asarray([3, 9], np.int32)
    path = np.asarray([[0, 2, 4, 3, 4], [0, 1, 2, 3, 4]], np.int32)
    jc = JModel(jcfg).commit_tree_path(jc, jnp.asarray(lengths), jnp.asarray(path))
    TModel.commit_tree_path(tc, lengths, path)
    np.testing.assert_array_equal(_t_stack(tc, "k"), _j_pool(jc, "k"))

    pjcfg, ptcfg = _configs(Tn, paged=True, page_size=4)
    jpc = JModel(pjcfg).init_cache(B, max_len)
    tpc = TModel(ptcfg, device="cpu").init_cache(B, max_len)
    pool = rng.standard_normal(_j_pool(jpc, "pv").shape).astype(np.float32)
    jpc["scan"]["b0"]["pv"] = jnp.asarray(pool)
    for i, c in enumerate(tpc):
        c["pv"][:-1].copy_(torch.from_numpy(pool[i]))
    jpc = JT.cow_copy_page(jpc, 2, 7, 4)
    assert TT.cow_copy_page(tpc, 2, 7, 4) is tpc
    np.testing.assert_array_equal(_t_stack(tpc, "pv")[:, :-1], _j_pool(jpc, "pv"))
