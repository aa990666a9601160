"""PyTorch port, paged KV bookkeeping: the port's copy of
``repro/core/pages.py`` against the reference, driven through one sequence
of operations (admissions with shared prefixes, ``ensure``, retirement,
eviction under a small pool, copy-on-write).  Gate: block tables,
refcounts and both snapshots IDENTICAL after every operation, and
``commit_maps`` equal on random accepted paths.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import pages as J
from repro_torch.core import pages as P

PS, SLOTS, MAX_PAGES, POOL = 4, 3, 6, 11


def _same(jp, jt, tp, tt, what):
    assert tp.snapshot() == jp.snapshot(), what
    assert tt.snapshot() == jt.snapshot(), what
    np.testing.assert_array_equal(tp.table, jp.table, err_msg=what)
    np.testing.assert_array_equal(tp.refcounts, jp.refcounts, err_msg=what)
    assert tt.nodes == jt.nodes, what


def _admit(pager, trie, b, prompt):
    """The serve loop's page binding (``ServeReplica._bind_pages``)."""
    shared = trie.probe(prompt, pager)
    for i, page in enumerate(shared):
        pager.table[b, i] = page
    pager.ensure(b, len(prompt), evict=lambda: trie.evict_one(pager))
    trie.insert(prompt, [int(pager.table[b, i]) for i in range(len(prompt) // PS)], pager)
    return len(shared)


def test_page_table_and_trie_follow_the_reference():
    rng = np.random.default_rng(0)
    system = rng.integers(0, 50, 8)
    prompts = [np.concatenate([system, rng.integers(0, 50, n)]) for n in (5, 9, 3, 6, 10, 2)]
    sides = []
    for mod in (J, P):
        sides.append((mod.PageTable(SLOTS, MAX_PAGES, POOL, PS), mod.PrefixTrie(PS)))
    (jp, jt), (tp, tt) = sides
    shared = []
    ops = [("admit", 0, 0), ("admit", 1, 1), ("ensure", 0, 19), ("admit", 2, 2), ("retire", 1, None),
           ("admit", 1, 3), ("ensure", 1, 22), ("retire", 0, None), ("retire", 2, None), ("admit", 0, 4),
           ("admit", 2, 5), ("cow", 0, 1), ("retire", 1, None), ("ensure", 2, 20)]
    for op, b, arg in ops:
        out = []
        for pager, trie in sides:
            if op == "admit":
                out.append(_admit(pager, trie, b, prompts[arg]))
            elif op == "ensure":
                out.append(pager.ensure(b, arg, evict=lambda: trie.evict_one(pager)))
            elif op == "retire":
                out.append(pager.free_slot(b))
            else:
                out.append(pager.ensure_writable(b, arg, evict=lambda: trie.evict_one(pager)))
        assert out[0] == out[1], (op, b, arg)
        if op == "admit":
            shared.append(out[0])
        if op == "cow":
            assert out[0] is not None           # the page was shared: it was copied
        _same(jp, jt, tp, tt, (op, b, arg))
    assert max(shared) > 0                      # the system prompt's pages were shared
    assert tp.occupancy() == jp.occupancy() and tp.fragmentation([5, 7]) == jp.fragmentation([5, 7])
    # round trips through the snapshots
    _same(jp, jt, P.PageTable.from_snapshot(tp.snapshot()), P.PrefixTrie.from_snapshot(tt.snapshot()), "restore")


def test_pool_exhaustion_evicts_then_raises_like_the_reference():
    outcome = []
    for mod in (J, P):
        pager, trie = mod.PageTable(2, 4, 4, PS), mod.PrefixTrie(PS)
        _admit(pager, trie, 0, np.arange(8))
        pager.free_slot(0)                     # the trie alone holds both pages
        _admit(pager, trie, 1, np.arange(100, 112))  # needs 3 pages: evicts one
        with pytest.raises(mod.PoolExhausted):
            pager.ensure(0, 16, evict=lambda: trie.evict_one(pager))
        outcome.append((pager.snapshot(), trie.snapshot()))
    assert outcome[0] == outcome[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_maps_match_reference(seed):
    rng = np.random.default_rng(seed)
    B, T = 4, 5
    lengths = rng.integers(0, 40, B).astype(np.int32)
    paths = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    accepts = rng.integers(1, T + 1, B).astype(np.int32)
    for b in range(B):
        paths[b, 1:accepts[b]] = np.sort(rng.choice(np.arange(1, T), accepts[b] - 1, replace=False))
    for got, want in zip(P.commit_maps(lengths, paths, accepts, T), J.commit_maps(lengths, paths, accepts, T)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
