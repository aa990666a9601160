"""PyTorch port, fork/join request programs, held against the JAX
reference's replica on the same weights and requests.

A fork admits K branches off ONE prefill: on the paged plane later
branches bind the prompt's full pages through the prefix trie (zero rows
copied for full pages, every page refcounted K + 1), contiguously the
first slot's rows, plan rows and state leaves are copied to the others.
Branch i's first token is the i-th best allowed token.  ``join="first"``
retires a branch that can no longer win, ``join="all"`` publishes every
branch.  Each case's streams and counters equal the reference replica's
(an Auto-axis mesh), and on the RecurrentGemma and Mamba-2 smoke configs
the state leaves and rolling buffers reach every branch.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.launch.serve import ServeReplica as JReplica
from repro.runtime.faults import RequestRejected as JRequestRejected
from repro_torch.core.plans import TreePlan
from repro_torch.core.programs import compile_program
from repro_torch.launch import serve as tserve
from repro_torch.runtime.fabric import Request
from repro_torch.runtime.faults import RequestRejected

from tests._torch_program_cases import (
    GEN,
    MAX_LEN,
    WIDTH,
    bridged,
    configs,
    drain,
    fork_counters,
    host_mesh,
    j_request,
    masked_oracle,
    shim_check_rep,
)


def _chars(text: str) -> list:
    return [ord(c) for c in text]


@pytest.fixture(scope="module")
def weights():
    cfg_j, cfg = configs(decode_plane=True, spec_tokens=WIDTH)
    return bridged(cfg_j, cfg)


@pytest.fixture
def pair(weights, monkeypatch):
    """make(fields, slots, **kw) -> (reference replica, port replica) on the
    MoE smoke config with ``fields``, the same weights."""
    shim_check_rep(monkeypatch)
    params_j, params = weights

    def make(slots, tree=None, **fields):
        kw = {k: fields.pop(k) for k in ("steer_drafter",) if k in fields}
        cfg_j, cfg = configs(decode_plane=True, spec_tokens=WIDTH, **fields)
        jtree = None
        if tree is not None:
            from repro.core.plans import TreePlan as JTreePlan

            jtree = JTreePlan.from_branching(list(tree))
        rep_j = JReplica(cfg_j, host_mesh(), slots, MAX_LEN, params_j, tree=jtree, **kw)
        rep = tserve.ServeReplica(cfg, slots, MAX_LEN, params,
                                  tree=TreePlan.from_branching(list(tree)) if tree else None, device="cpu", **kw)
        return rep_j, rep

    return make


def _both(rep_j, rep, reqs):
    want = drain(rep_j, reqs, j_request)
    got = drain(rep, reqs)
    assert {rid: (r.tokens, r.branches) for rid, r in got.items()} == \
        {rid: (r.tokens, r.branches) for rid, r in want.items()}
    assert fork_counters(rep) == fork_counters(rep_j)
    return got


def test_fork_shares_prompt_pages_zero_copy(pair):
    """3-way fork off one page-aligned prompt: one admission prefill, zero
    KV rows copied, every prompt page refcounted K+1 (K branches + trie)."""
    rep_j, rep = pair(3, paged=True, page_size=4)
    spec = {"fork": 3, "join": "first",
            "segments": [{"kind": "json_schema", "schema": {"enum": [17, 42, 99]}}]}
    prompt = np.random.default_rng(5).integers(0, rep.cfg.vocab_size, size=8).astype(np.int32)
    req = Request(rid=0, prompt=prompt, gen=GEN, program=spec)
    rep_j.admit(j_request(req))
    rep.admit(req)
    assert rep.prefills == 1 and rep.fork_kv_rows_copied == 0
    assert rep.forks_started == 1 and rep.forks_live_max == 3
    np.testing.assert_array_equal(rep.pager.table, rep_j.pager.table)
    np.testing.assert_array_equal(rep.pager.refcounts, rep_j.pager.refcounts)
    tables = [rep.pager.table[b, :2].copy() for b in range(3)]
    for t in tables[1:]:  # branches alias the same physical prompt pages
        assert np.array_equal(t, tables[0])
    for page in tables[0]:
        assert rep.pager.refcounts[int(page)] == 4  # 3 branches + the trie
    np.testing.assert_array_equal(rep.last_tok, rep_j.last_tok)
    assert {int(rep.last_tok[b]) for b in range(3)} == {ord("1"), ord("4"), ord("9")}

    results = _both(rep_j, rep, [])
    assert set(results) == {0}
    assert compile_program(spec, rep.cfg.vocab_size).automaton.accepts(results[0].tokens)
    assert not rep.forks and not rep.active.any()
    for page in tables[0]:  # losers' pages recycled: only the trie pins the prompt
        assert rep.pager.refcounts[int(page)] == 1
    assert int((rep.pager.refcounts > 0).sum()) == 2
    np.testing.assert_array_equal(rep.pager.refcounts, rep_j.pager.refcounts)


def test_fork_partial_page_copies_only_its_rows(pair):
    """A prompt that ends mid-page: each later branch writes only the rows
    of the partial last page (full pages are bound by pointer), the count
    the reference's fork_kv_rows_copied gives."""
    rep_j, rep = pair(2, paged=True, page_size=4)
    spec = {"fork": 2, "join": "all", "segments": [{"kind": "json_schema", "schema": {"enum": [17, 42]}}]}
    prompt = np.random.default_rng(9).integers(0, rep.cfg.vocab_size, size=10).astype(np.int32)
    _both(rep_j, rep, [Request(rid=0, prompt=prompt, gen=GEN - 2, program=spec)])
    assert rep.fork_kv_rows_copied == 10 % 4 == rep_j.fork_kv_rows_copied


def test_fork_join_first_retires_longer_branch_early(pair):
    """join="first": "7" accepts after 1 token, "1234" needs 4: the loser
    is retired once it cannot win and its slot and pages recycled."""
    rep_j, rep = pair(2, paged=True, page_size=4)
    spec = {"fork": 2, "join": "first", "segments": [{"kind": "json_schema", "schema": {"enum": [7, 1234]}}]}
    prompt = np.random.default_rng(6).integers(0, rep.cfg.vocab_size, size=8).astype(np.int32)
    results = _both(rep_j, rep, [Request(rid=0, prompt=prompt, gen=GEN, program=spec)])
    assert results[0].tokens == [ord("7")]
    assert rep.prog_masked_emissions == 0 and not rep.forks and not rep.active.any()
    assert int((rep.pager.refcounts > 1).sum()) == 0


def test_fork_join_all_publishes_every_branch(pair):
    rep_j, rep = pair(2)
    spec = {"fork": 2, "join": "all", "segments": [{"kind": "json_schema", "schema": {"enum": [17, 42]}}]}
    prompt = np.random.default_rng(7).integers(0, rep.cfg.vocab_size, size=8).astype(np.int32)
    res = _both(rep_j, rep, [Request(rid=0, prompt=prompt, gen=GEN, program=spec)])[0]
    assert res.branches is not None and len(res.branches) == 2
    assert {tuple(b) for b in res.branches} == {tuple(_chars("17")), tuple(_chars("42"))}
    assert res.tokens == res.branches[0] + res.branches[1]
    assert rep.fork_kv_rows_copied == len(prompt)  # contiguous: the whole prompt, as the reference counts


def test_fork_branch_rejects_mid_draft_while_sibling_commits(pair, weights):
    """Steering off: the ngram drafter keeps proposing masked tokens, so
    branches reject draft nodes mid-verify while the sibling commits;
    every branch still equals its forced-first-token masked oracle."""
    rep_j, rep = pair(2, tree=(2,), steer_drafter=False)
    spec = {"fork": 2, "join": "all", "segments": [{"kind": "json_schema", "schema": {"enum": [17, 42]}},
                                                  {"kind": "literal", "text": ";ok"}]}
    prompt = np.random.default_rng(8).integers(0, rep.cfg.vocab_size, size=8).astype(np.int32)
    req = Request(rid=0, prompt=prompt, gen=GEN, program=spec)
    res = _both(rep_j, rep, [req])[0]
    assert res.error is None and len(res.branches) == 2
    assert rep.prog_masked_emissions == 0 and rep.accepted_total < rep.drafted_total
    params_j, _ = weights
    for i, branch in enumerate(res.branches):
        assert branch == masked_oracle(rep_j.cfg, params_j, [req], spec, MAX_LEN, first_rank=i)[0]


def test_fork_wider_than_pool_is_rejected_permanently(pair):
    rep_j, rep = pair(2)
    spec = {"fork": 3, "segments": [{"kind": "json_schema", "schema": {"enum": [1, 2, 3]}}]}
    spec1 = {"fork": 2, "segments": [{"kind": "literal", "text": "ab"}]}  # one first token only
    for rid, s in enumerate((spec, spec1)):
        req = Request(rid=rid, prompt=np.zeros((4,), np.int32), gen=2, program=s)
        with pytest.raises(RequestRejected):
            rep.admit(req)
        with pytest.raises(JRequestRejected):
            rep_j.admit(j_request(req))
    assert not rep.active.any() and rep.prefills == 0  # nothing left behind


@pytest.mark.parametrize("arch,sizes", [("recurrentgemma-2b", (24, 30)), ("mamba2-2.7b", (12, 20))])
def test_fork_reaches_state_leaves_and_rolling_buffers(arch, sizes):
    """Width 1 on the hybrid and SSM smoke configs: a 2-way fork copies the
    first branch's RG-LRU / SSD state, conv tails and rolling buffers to
    the second (bitwise after admission), and the served streams and
    counters equal the reference replica's."""
    cfg_j, cfg = configs(arch, decode_plane=True)
    params_j, params = bridged(cfg_j, cfg)
    spec = {"fork": 2, "join": "all", "segments": [{"kind": "json_schema", "schema": {"enum": [17, 42]}},
                                                  {"kind": "literal", "text": ";ok"}]}
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), gen=8, program=spec)
            for i, n in enumerate(sizes)]
    max_len = max(sizes) + 8 + 1
    rep = tserve.ServeReplica(cfg, 2, max_len, params, device="cpu")
    rep.admit(reqs[0])
    for c in rep.cache:
        for name, leaf in c.items():
            assert torch.equal(leaf[0], leaf[1]), f"{name} did not reach the second branch"
    assert rep.last_tok[0] != rep.last_tok[1]
    got = drain(rep, reqs[1:])  # the first request is already in its slots
    rep_j = JReplica(cfg_j, host_mesh(), 2, max_len, params_j)
    want = drain(rep_j, reqs, j_request)
    assert {rid: (r.tokens, r.branches) for rid, r in got.items()} == \
        {rid: (r.tokens, r.branches) for rid, r in want.items()}
    assert fork_counters(rep) == fork_counters(rep_j)
    assert rep.prog_masked_emissions == 0 and rep.forks_started == 2
