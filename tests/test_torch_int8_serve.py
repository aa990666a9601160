"""PyTorch port, the quantized bandwidth plane end to end on the CPU: int8
KV rows with per-token scales and int8 expert twins with per-expert scales,
held against the JAX reference's jnp paths (``use_pallas=False``: its int8
interpret path fails on this jax, ROADMAP Queue C, R1) on an Auto-axis
mesh (R2), with the reference's weights bridged through numpy.

Gates:
* model: prefill and decode logits within 1e-5 (f32; the sides sum in
  other orders), scale leaves within 1e-6 relative, int8 payloads at most 1
  code apart (the count of such codes is recorded; a row whose f32 values
  straddle a rounding tie may land one code apart), plan ids exact;
* serving: per-request streams IDENTICAL to the reference's for chains at
  spec 1 and 4, the paged plane with tree 2,1 behind a shared prefix, and
  the RecurrentGemma smoke stack over rolling windows;
* the reference's own int8 invariants (``tests/test_quant.py``) on the
  port: spec-4 streams equal sequential greedy (contiguous, paged, and a
  rolling window across its wrap), the paged chain is bitwise the
  contiguous chain, and CoW copies scale rows with their payload (no
  aliasing);
* the CLI: ``--model 2`` under ``torchrun`` with int8 experts and KV
  serves ``--model 1``'s streams; ``--batch`` is ``--slots``.
"""
from __future__ import annotations

import dataclasses
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.checkpoint.manager import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.core.plans import TreePlan as JTree
from repro.launch.serve import ServeReplica as JReplica
from repro.models.model import Model as JModel
from repro.runtime.fabric import Request as JRequest
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.pages import PageTable
from repro_torch.core.plans import TreePlan
from repro_torch.launch import serve as tserve
from repro_torch.launch.speculative import draft_tree_ngram
from repro_torch.models import transformer as T
from repro_torch.models.model import Model as TModel
from test_torch_ep_serve import _cli

ARCH, HYBRID = "qwen3-moe-235b-a22b", "recurrentgemma-2b"
INT8 = dict(kv_dtype="int8", expert_dtype="int8")
TOL = 1e-5


def _host_mesh():
    """A (1, 1) mesh with Auto axes (see ``tests/test_torch_serve.py``)."""
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


def _bridge(jparams):
    names, leaves, _ = _flatten(jparams)
    return {n: np.asarray(v) for n, v in zip(names, leaves)}


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def _compare_cache(tc, jc, what):
    """Scales within 1e-6 relative, payload codes at most 1 apart, plans
    exact; returns the number of payload codes that differ."""
    blk = jc["scan"]["b0"]
    for name in ("ks", "vs"):
        np.testing.assert_allclose(np.stack([c[name].numpy() for c in tc]), np.asarray(blk[name]), rtol=1e-6,
                                   atol=0, err_msg=f"{what} {name}")
    off = 0
    for name in ("k", "v"):
        got = np.stack([c[name].numpy() for c in tc]).astype(np.int32)
        want = np.asarray(blk[name]).astype(np.int32)
        assert got.dtype == want.dtype and np.abs(got - want).max() <= 1, f"{what} {name}"
        off += int((got != want).sum())
    np.testing.assert_array_equal(np.stack([c["plan_e"].numpy() for c in tc]), np.asarray(blk["plan_e"]))
    return off


def test_int8_model_matches_reference(record_property):
    Tn, B, S, launches = 4, 2, 9, 4
    kw = dict(decode_plane=True, spec_tokens=Tn, num_experts=16, top_k=2, **INT8)
    jcfg, tcfg = dataclasses.replace(j_smoke(ARCH), **kw), dataclasses.replace(t_smoke(ARCH), **kw)
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, _bridge(jp), "cpu")
    max_len = S + launches * Tn + Tn
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jc = jm.init_cache(B, max_len)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jc)
    tc = tm.init_cache(B, max_len)
    assert tc[0]["k"].dtype == torch.int8 and tc[0]["ks"].dtype == torch.float32
    tl = tm.prefill(tp, prompts, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    off = _compare_cache(tc, jc, "prefill")
    jdec = jax.jit(jm.decode_tokens)
    tree = TreePlan.chain(Tn)
    last = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    history = [[int(t)] for t in last]
    lengths, prev = np.full((B,), S, np.int32), np.zeros((B,), np.int32)
    for step in range(launches):
        toks = np.stack([draft_tree_ngram(history[b], int(last[b]), tree) for b in range(B)]).astype(np.int32)
        jlg, jc = jdec(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(prev))
        tlg = tm.decode_tokens(tp, tc, toks, lengths, prev)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL, err_msg=f"launch {step}")
        off += _compare_cache(tc, jc, f"launch {step}")
        y = np.asarray(jnp.argmax(jlg, -1))
        for b in range(B):
            a = 1
            while a < Tn and toks[b, a] == y[b, a - 1]:
                a += 1
            history[b].extend(int(t) for t in y[b, :a])
            lengths[b] += a
            prev[b] = a - 1
            last[b] = y[b, a - 1]
    record_property("int8_codes_one_apart", off)


# ---------------------------------------------------------------------------
# serving against the reference
# ---------------------------------------------------------------------------

SLOTS, PROMPT, GEN, N_REQ = 2, 8, 4, 4
# name -> (arch, tree branching or None, spec width, paged, page size, shared prefix, prompt)
CASES = {
    "chain spec 1": (ARCH, None, 1, False, 16, 0, PROMPT),
    "chain spec 4": (ARCH, None, 4, False, 16, 0, PROMPT),
    "paged tree 2,1 shared 16": (ARCH, (2, 1), 0, True, 8, 16, PROMPT),
    "recurrentgemma rolling": (HYBRID, None, 1, False, 16, 0, 40),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_int8_serve_streams_match_reference(name):
    arch, branching, spec, paged, ps, shared, prompt = CASES[name]
    tree = TreePlan.from_branching(branching) if branching else None
    Tn = tree.num_nodes if tree else spec
    kw = dict(decode_plane=True, spec_tokens=Tn, paged=paged, page_size=ps, kv_dtype="int8")
    if arch == ARCH:
        kw["expert_dtype"] = "int8"
    max_len = prompt + shared + GEN + Tn
    reqs = tserve.synthetic_requests(256, prompt, GEN, N_REQ, shared)
    jcfg = dataclasses.replace(j_smoke(arch), **kw)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    jrep = JReplica(jcfg, _host_mesh(), SLOTS, max_len, jp, tree=JTree(tree.parents) if tree else None,
                    drafter="ngram")
    queue, want = list(reqs), {}
    while queue or jrep.has_work():
        while queue and jrep.free_slots():
            r = queue.pop(0)
            jrep.admit(JRequest(rid=r.rid, prompt=r.prompt, gen=r.gen))
        for res in jrep.step():
            want[res.rid] = res.tokens
    tcfg = dataclasses.replace(t_smoke(arch), **kw)
    rep = tserve.ServeReplica(tcfg, SLOTS, max_len, params_from_numpy(tcfg, _bridge(jp), "cpu"), tree=tree,
                              drafter="ngram", device="cpu")
    got = tserve.serve_queue(rep, reqs)
    assert {rid: r.tokens for rid, r in got.items()} == want
    assert all(len(t) == GEN + 1 for t in want.values())
    leaf = rep.cache[-1]
    assert (leaf["pk"] if paged else leaf["k"]).dtype == torch.int8
    if paged:
        assert rep.pager.snapshot() == jrep.pager.snapshot()
        assert rep.pages_shared_total == jrep.pages_shared_total > 0
    if arch == HYBRID:
        assert leaf["k"].shape[1] == tcfg.local_window < min(len(r.prompt) for r in reqs)


# ---------------------------------------------------------------------------
# the reference's int8 invariants, on the port
# ---------------------------------------------------------------------------


def _moe_cfg(**kw):
    return dataclasses.replace(t_smoke(ARCH), num_experts=16, top_k=2, decode_plane=True, **kw)


def _sequential(model, params, prompts, max_len, gen):
    """(gen + 1) greedy tokens per prompt at width 1."""
    m = TModel(dataclasses.replace(model.cfg, spec_tokens=1, paged=False), device="cpu")
    cache = m.init_cache(prompts.shape[0], max_len)
    toks = m.prefill(params, prompts, cache).argmax(-1)
    out = [toks.numpy()]
    for i in range(gen):
        toks = m.decode_tokens(params, cache, toks[:, None].numpy(), np.full((len(toks),), prompts.shape[1] + i))
        toks = toks[:, 0].argmax(-1)
        out.append(toks.numpy())
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged", "rolling window"])
def test_int8_spec_decode_equals_sequential_greedy(layout):
    Tn, B, S = (3, 2, 14) if layout == "rolling window" else (4, 2, 8)
    kw = dict(INT8)
    if layout == "rolling window":  # 16 rows (window 8 + slack 8): launch 2 crosses the wrap
        kw.update(attention_kind="local", local_window=8, num_layers=1)
    cfg = _moe_cfg(spec_tokens=Tn, **kw)
    model = TModel(cfg, device="cpu")
    params = model.init(0)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    max_len = 24
    seq = _sequential(model, params, prompts, max_len, 2 * Tn)
    cache = model.init_cache(B, max_len)
    model.prefill(params, prompts, cache)
    pages = None
    if layout == "paged":
        pm = TModel(dataclasses.replace(cfg, paged=True, page_size=4), device="cpu")
        cache, model = pm.paginate_cache(cache, max_len), pm
        pages = T.identity_page_table(pm.cfg, B, max_len).numpy()
    if layout == "rolling window":
        assert cache[0]["k"].shape[1] < S + 2 * Tn
    for launch in range(2):
        draft = np.stack(seq[launch * Tn:(launch + 1) * Tn], axis=1)
        lens = np.full((B,), S + launch * Tn)
        acc = np.full((B,), 0 if launch == 0 else Tn - 1)
        lg = model.decode_tokens(params, cache, draft, lens, acc, pages=pages, max_len=max_len)
        for t in range(Tn):
            np.testing.assert_array_equal(lg[:, t].argmax(-1).numpy(), seq[launch * Tn + t + 1],
                                          err_msg=f"launch {launch} t {t}")


def test_int8_paged_chain_bitwise_equals_contiguous():
    Tn, B, S, max_len = 4, 2, 8, 32
    cfg = _moe_cfg(spec_tokens=Tn, page_size=8, **INT8)
    m = TModel(cfg, device="cpu")
    params = m.init(0)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    cache = m.init_cache(B, max_len)
    m.prefill(params, prompts, cache)
    draft = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, Tn)).astype(np.int32)
    lens, acc = np.full((B,), S), np.zeros((B,), np.int64)
    pm = TModel(dataclasses.replace(cfg, paged=True), device="cpu")
    pcache = pm.paginate_cache(cache, max_len)
    assert float(pcache[0]["pks"][-1]) == 1.0 and pcache[0]["pks"].shape == pcache[0]["pk"].shape[:1]
    lg_c = m.decode_tokens(params, cache, draft, lens, acc)
    lg_p = pm.decode_tokens(params, pcache, draft, lens, acc, pages=T.identity_page_table(pm.cfg, B, max_len).numpy())
    assert torch.equal(lg_c, lg_p)
    for c, p in zip(cache, pcache):  # the launch wrote the same (int8 row, scale) pairs
        mp = max_len // cfg.page_size
        for name in ("k", "v", "ks", "vs"):
            flat = p["p" + name][:-1].reshape(B, mp * cfg.page_size, *c[name].shape[2:])
            assert torch.equal(flat[:, :c[name].shape[1]], c[name]), name


def test_int8_paged_cow_deep_copies_scale_rows():
    cfg = _moe_cfg(paged=True, page_size=4, kv_dtype="int8")
    cache = TModel(cfg, device="cpu").init_cache(2, 16)
    ps = cfg.page_size
    blk = cache[0]
    blk["pk"][0:ps] = 7
    blk["pks"][0:ps] = 0.5
    pt = PageTable(slots=2, max_pages=16 // ps, num_pages=(blk["pk"].shape[0] - 1) // ps, page_size=ps)
    assert pt.alloc() == 0
    pt.table[0, 0] = 0
    pt.adopt(1, 0, 0)  # slot 1 shares slot 0's page (a prefix-trie hit)
    old = pt.ensure_writable(1, 0)
    new = int(pt.table[1, 0])
    assert old == 0 and new != 0
    T.cow_copy_page(cache, old, new, ps)
    n0 = new * ps
    assert bool((blk["pk"][n0:n0 + ps] == 7).all()) and bool((blk["pks"][n0:n0 + ps] == 0.5).all())
    blk["pk"][n0:n0 + ps] = -3  # the writer's private rows ...
    blk["pks"][n0:n0 + ps] = 9.0
    assert bool((blk["pk"][0:ps] == 7).all()) and bool((blk["pks"][0:ps] == 0.5).all())  # ... leave the shared page


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_model_2_int8_serves_the_single_rank_streams(tmp_path):
    args = ["--spec-tokens", "4", "--kv-dtype", "int8", "--expert-dtype", "int8"]
    two = _cli(args + ["--model", "2", "--dump-tokens", str(tmp_path / "two.json")], tmp_path,
               ("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"))
    assert two.returncode == 0, two.stderr[-3000:]
    assert "'model': 2" in two.stdout
    # the one-rank side in this process (the CLI's own one-rank group, torn
    # down before it returns), with _cli's arguments
    assert tserve.main(["--arch", ARCH, "--smoke", "--decode-plane", "--slots", "2", "--prompt-len", "16", "--gen",
                        "8", "--device", "cpu", *args, "--dump-tokens", str(tmp_path / "one.json")]) == 0
    streams = json.loads((tmp_path / "two.json").read_text())
    assert sorted(streams) == ["0", "1", "2", "3"] and all(len(s) == 9 for s in streams.values())
    assert streams == json.loads((tmp_path / "one.json").read_text())


def test_cli_batch_is_slots_and_serves_int8(tmp_path, monkeypatch, capsys):
    built = []
    init = tserve.ServeReplica.__init__

    def record(self, cfg, slots, *a, **kw):
        built.append((cfg, slots))
        init(self, cfg, slots, *a, **kw)

    monkeypatch.setattr(tserve.ServeReplica, "__init__", record)
    common = ["--arch", ARCH, "--smoke", "--decode-plane", "--spec-tokens", "2", "--prompt-len", "8", "--gen", "3",
              "--device", "cpu", "--kv-dtype", "int8", "--expert-dtype", "int8"]
    for flag in ("--batch", "--slots"):
        assert tserve.main(common + [flag, "2", "--dump-tokens", str(tmp_path / f"{flag[2:]}.json")]) == 0
    assert "served 4 requests on 2 slots" in capsys.readouterr().out
    (cfg_b, slots_b), (cfg_s, slots_s) = built
    assert slots_b == slots_s == 2 and cfg_b == cfg_s
    assert cfg_b.kv_dtype == cfg_b.expert_dtype == "int8"
    assert json.loads((tmp_path / "batch.json").read_text()) == json.loads((tmp_path / "slots.json").read_text())
