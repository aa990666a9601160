"""PyTorch port, rolling-window (local attention) layers on the paged KV
plane: ports of the reference's ``tests/test_paged_decode.py`` rolling
cases on its ``_local_cfg`` (Qwen3-32B smoke, one local-attention layer),
plus the int8 rolling tree and RecurrentGemma on ``--paged``.

Gates:

* rolling buffers stay modulo-addressed under ``cfg.paged``: a chain
  decoded across the wrap point is bitwise the unpaged model's
  (``test_paged_rolling_chain_crosses_wrap_bitwise``);
* a 2,1 draft tree on rolling layers serves through the paged plane (its
  accepted rows moved mod W by the next launch's commit maps, no commit
  launch) and every stream equals sequential greedy, full precision and
  int8 KV; the full-precision streams also equal the reference replica's
  (``test_tree_draft_on_rolling_window_layers_matches_sequential_greedy``);
* without paging a branchy tree on rolling layers is refused with the
  reference's message, which names the paged plane
  (``test_tree_draft_on_rolling_window_still_banned_without_paging``);
* the rolling commit moves rows mod W, its no-op entries write nothing;
* RecurrentGemma smoke served ``--paged`` gives its unpaged streams and the
  reference replica's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from _torch_arch_cases import reference_and_port_streams
from repro.configs import get_smoke_config as j_smoke
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.plans import TreePlan
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.runtime.fabric import Request


def _local_cfg(get=t_smoke, **kw):
    """Dense single-layer local-attention config: every layer is a
    rolling-window layer, the shape the contiguous plane bans trees on."""
    return dataclasses.replace(get("qwen3-32b"), num_layers=1, attention_kind="local", decode_plane=True, **kw)


@pytest.mark.parametrize("max_len,launches", [(16, 3), (40, 12)])
def test_paged_rolling_chain_crosses_wrap_bitwise(max_len, launches):
    """The reference's case (3 launches, max_len 16), and 12 launches
    through a 16-slot buffer (the window 8 plus the spec slack), which wrap
    it."""
    W, Tn = 8, 2
    cfg = _local_cfg(local_window=W, spec_tokens=Tn, page_size=8)
    B, S = 2, 6
    m = Model(cfg, device="cpu")
    params = m.init(0)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    cache = m.init_cache(B, max_len)
    m.prefill(params, prompts, cache)
    pm = Model(dataclasses.replace(cfg, paged=True), device="cpu")
    pcache = pm.paginate_cache(cache, max_len)
    rows = T.rolling_rows(cfg, max_len, "attn")
    assert all("pk" not in c and c["k"].shape[1] == rows for c in pcache)  # rolling leaves stay unpaged
    assert all("pk" not in c for c in pm.init_cache(B, max_len))
    pages = T.identity_page_table(pm.cfg, B, max_len)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, launches, Tn))
    for i in range(launches):
        lens = np.full((B,), S + i * Tn)
        acc = np.full((B,), 0 if i == 0 else Tn - 1)
        lg_c = m.decode_tokens(params, cache, toks[:, i], lens, acc)
        lg_p = pm.decode_tokens(params, pcache, toks[:, i], lens, acc, pages=pages)
        assert torch.equal(lg_c, lg_p), f"launch {i}"


def _sequential_greedy(cfg, params, prompt, gen, max_len):
    m1 = Model(dataclasses.replace(cfg, spec_tokens=1, paged=False), device="cpu")
    cache = m1.init_cache(1, max_len)
    tok = int(m1.prefill(params, np.asarray(prompt)[None], cache)[0].argmax())
    out = [tok]
    for i in range(gen):
        tok = int(m1.decode_tokens(params, cache, [[tok]], [len(prompt) + i])[0, 0].argmax())
        out.append(tok)
    return out


def _drain(rep):
    done = {}
    while rep.has_work():
        for r in rep.step():
            done[r.rid] = r.tokens
    return done


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_tree_draft_on_rolling_window_layers_matches_sequential_greedy(kv_dtype):
    tree = TreePlan.from_branching([2, 1]).validate()
    gen, S, W = 6, 6, 8
    cfg = _local_cfg(local_window=W, spec_tokens=tree.num_nodes, paged=True, page_size=4, kv_dtype=kv_dtype)
    max_len = S + gen + tree.num_nodes
    params = Model(cfg, device="cpu").init(0)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=S).astype(np.int32)
    rep = tserve.ServeReplica(cfg, 1, max_len, params, tree=tree, device="cpu")
    assert rep._commit is None  # the paged commit is fused: no compaction launch
    assert rep._decode.branchy and "ks" in rep.cache[0] if kv_dtype else "k" in rep.cache[0]
    rep.admit(Request(rid=0, prompt=prompt, gen=gen))
    done = _drain(rep)
    assert done[0] == _sequential_greedy(cfg, params, prompt, gen, max_len)


def _sibling_drafter(oracle):
    """Drafts for the 2,1 tree whose accepted path runs through node 2 (the
    second child): node 1 proposes a wrong token, node 2 the sequential
    stream's next, so every launch accepts (0, 2) and moves row L + 2 to
    L + 1 through the next launch's commit maps."""
    def fill(history, last, tree):
        n = len(history)
        nxt = oracle[n] if n < len(oracle) else 0
        return np.asarray([last, (nxt + 1) % 256, nxt, 0], np.int32)
    return fill


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_rolling_tree_commit_maps_move_accepted_siblings(kv_dtype):
    """The accepted path runs through a sibling at every launch, across the
    wrap of the rolling buffer (window 8, 16 slots; 20 generated): the
    stream is still sequential greedy, and every launch moved a row."""
    tree = TreePlan.from_branching([2, 1]).validate()
    assert tree.parents[2] == 0
    gen, S = 20, 6
    cfg = _local_cfg(local_window=8, spec_tokens=tree.num_nodes, paged=True, page_size=4, kv_dtype=kv_dtype)
    max_len = S + gen + tree.num_nodes
    params = Model(cfg, device="cpu").init(0)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=S).astype(np.int32)
    oracle = _sequential_greedy(cfg, params, prompt, gen, max_len)
    rep = tserve.ServeReplica(cfg, 1, max_len, params, tree=tree, device="cpu")
    rep._fill = _sibling_drafter(oracle)
    rep.admit(Request(rid=0, prompt=prompt, gen=gen))
    assert _drain(rep)[0] == oracle
    assert rep.commit_moves == rep.launches == gen // 2


def test_rolling_tree_streams_match_reference_replica(monkeypatch):
    """A longer run across the wrap (prompts of 6-12 tokens, 10 generated,
    W = 8): the port's paged rolling tree against the reference replica."""
    tree = TreePlan.from_branching([2, 1]).validate()
    kw = dict(local_window=8, spec_tokens=tree.num_nodes, paged=True, page_size=4)
    jcfg, tcfg = _local_cfg(j_smoke, **kw), _local_cfg(**kw)
    from repro.core.plans import TreePlan as JTree

    want, got, rep = reference_and_port_streams(jcfg, tcfg, 2, 12, 10, 4, monkeypatch,
                                                tree=(JTree.from_branching([2, 1]).validate(), tree))
    assert got == want


def test_tree_draft_on_rolling_window_still_banned_without_paging():
    tree = TreePlan.from_branching([2, 1]).validate()
    cfg = _local_cfg(local_window=8, spec_tokens=tree.num_nodes, paged=False)
    params = Model(cfg, device="cpu").init(0)
    with pytest.raises(NotImplementedError, match="paged"):
        rep = tserve.ServeReplica(cfg, 1, 20, params, tree=tree, device="cpu")
        rep.admit(Request(rid=0, prompt=np.arange(6, dtype=np.int32), gen=4))
        rep.step()


def test_rolling_commit_moves_rows_mod_w_and_drops_noops():
    cfg = _local_cfg(local_window=8, spec_tokens=4, paged=True)
    c = T.init_layer_cache("attn", cfg, 2, 32, "cpu")
    W = c["k"].shape[1]
    assert W == 16  # the window plus the spec slack, rounded to 8
    for name in ("k", "v"):
        c[name].copy_(torch.arange(c[name].numel(), dtype=c[name].dtype).reshape(c[name].shape))
    before = {n: t.clone() for n, t in c.items()}
    # slot 0: L = 14, path (0, 2, 3): rows 16 <- 16 + ... crosses the wrap
    dst = torch.tensor([[-1, 15, 16, -1], [-1, -1, -1, -1]])
    src = torch.tensor([[-1, 16, 17, -1], [-1, -1, -1, -1]])
    T._apply_commit(c, (dst, src), None, cfg)
    for name in ("k", "v"):
        want = before[name].clone()
        want[0, 15 % W] = before[name][0, 16 % W]
        want[0, 16 % W] = before[name][0, 17 % W]
        assert torch.equal(c[name], want)


def test_recurrentgemma_paged_streams_equal_unpaged_and_reference(monkeypatch):
    kw = dict(decode_plane=True)
    jcfg = dataclasses.replace(j_smoke("recurrentgemma-2b"), **kw)
    tcfg = dataclasses.replace(t_smoke("recurrentgemma-2b"), **kw)
    want, unpaged, rep = reference_and_port_streams(jcfg, tcfg, 2, 24, 8, 4, monkeypatch)
    assert unpaged == want
    pcfg = dataclasses.replace(tcfg, paged=True, page_size=8)
    prep = tserve.ServeReplica(pcfg, 2, 24 + 8 + 1, rep.params, device="cpu")
    assert prep.pager is not None and all("pk" not in c for c in prep.cache)
    got = tserve.serve_queue(prep, tserve.synthetic_requests(pcfg.vocab_size, 24, 8, 4))
    assert {rid: r.tokens for rid, r in got.items()} == want and prep.admissions_paged == 4
