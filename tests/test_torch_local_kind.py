"""PyTorch port, the per-layer ``local`` block kind: one stack mixing full
and rolling-window attention layers, held against the reference on the CPU
with its weights bridged through numpy.

The stack is Qwen1.5-4B's smoke config with ``block_pattern=("attn",
"local")`` and ``local_window=8`` (layer 0 full attention, layer 1 a
rolling window), on the decode plane.  Gates:

* the window is decided per layer, by the reference's rule (``local``
  layers, and every attention layer under ``attention_kind="local"``);
* ``Model.init`` gives the reference's leaves (names, shapes, types) and
  ``Model.init_cache`` its cache, layer by layer, on the contiguous and the
  paged plane (the full layer pooled, with the port's one trash row; the
  rolling layer unpaged);
* prefill logits and the T = 2 decode launches' logits within the port's
  f32 tolerance (1e-5) of the reference's and greedy ids equal, prompts
  past the window and launches past the rolling buffer's wrap, on the
  contiguous plane and, from the paginated prefill cache with the identity
  block table, on the paged plane;
* the CLI's synthetic queue served at spec 2 by the port's replica equals
  the reference replica's streams exactly, contiguous and paged (and a 2,1
  draft tree on the paged plane, whose commit maps move the rolling layer's
  rows mod W); the contiguous plane refuses a branchy tree, as the
  reference does.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_arch_cases import TOL, bridge, compare_logits, reference_and_port_streams
from repro.configs import get_smoke_config as j_smoke
from repro.core.plans import TreePlan as JTreePlan
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch.checkpoint import params_from_numpy
from repro_torch.checkpoint.bridge import leaves_from_params
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.plans import TreePlan
from repro_torch.models import transformer as T
from repro_torch.models.model import Model

ARCH = "qwen1.5-4b"
MIXED = dict(block_pattern=("attn", "local"), local_window=8, decode_plane=True)


def _cfgs(**kw):
    """(reference config, port config): the mixed stack, with ``kw``."""
    return (dataclasses.replace(j_smoke(ARCH), **MIXED, **kw),
            dataclasses.replace(t_smoke(ARCH), **MIXED, **kw))


def test_window_is_decided_per_layer():
    _, cfg = _cfgs()
    assert cfg.layer_kinds == ("attn", "local")
    assert T.window_of(cfg, "attn") == 0 and T.window_of(cfg, "local") == 8
    assert T.has_full_attention(cfg)
    assert T.rolling_rows(cfg, 40, "attn") == 40 and T.rolling_rows(cfg, 40, "local") == 8
    every = dataclasses.replace(cfg, attention_kind="local")
    assert T.window_of(every, "attn") == T.window_of(every, "local") == 8
    assert not T.has_full_attention(every)
    with pytest.raises(ValueError, match="local_window > 0"):
        Model(dataclasses.replace(cfg, local_window=0), device="cpu").init(0)


def _reference_cache_layers(jcfg, jcache) -> list:
    """The reference's cache as one {leaf: array} per layer (its super-block
    axis un-stacked, its tail appended)."""
    pat = jcfg.block_pattern
    n_sb = jcfg.num_layers // len(pat)
    layers = []
    for s in range(n_sb):
        for j in range(len(pat)):
            layers.append({n: np.asarray(leaf[s]) for n, leaf in jcache["scan"][f"b{j}"].items()})
    for c in jcache["rest"]:
        layers.append({n: np.asarray(leaf) for n, leaf in c.items()})
    return layers


@pytest.mark.parametrize("paged", [False, True])
def test_init_and_cache_match_reference(paged):
    jcfg, tcfg = _cfgs(spec_tokens=2, paged=paged, page_size=8)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    want = bridge(jp)
    got = {name: make() for name, make in leaves_from_params(tcfg, Model(tcfg, device="cpu").init(0))}
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(arr.dtype), name

    B, max_len = 2, 30
    jlayers = _reference_cache_layers(jcfg, JModel(jcfg).init_cache(B, max_len))
    tlayers = Model(tcfg, device="cpu").init_cache(B, max_len)
    assert len(jlayers) == len(tlayers) == 2
    for i, (jc, tc) in enumerate(zip(jlayers, tlayers)):
        assert sorted(jc) == sorted(tc), i
        for name, arr in jc.items():
            leaf = tc[name]
            if name in T.POOL_LEAVES:  # the port's pool carries one trash row past its pages
                assert leaf.shape[0] == arr.shape[0] + 1
                leaf = leaf[:-1]
            np.testing.assert_array_equal(leaf.numpy(), arr, err_msg=f"layer {i} {name}")
    assert ("pk" in tlayers[0]) == paged and "k" in tlayers[1]
    assert tlayers[1]["k"].shape[1] == T.rolling_rows(tcfg, max_len, "local") == 16


def test_prefill_and_decode_logits_match_reference():
    """Prompts of 12 tokens (past the window of 8), then 6 launches of 2
    tokens through a 16-slot rolling buffer (the window plus the spec
    slack), which wrap it."""
    jcfg, tcfg = _cfgs()
    compare_logits(jcfg, tcfg, B=2, S=12, launches=6, Tn=2)


def test_paged_prefill_and_decode_logits_match_reference():
    """The same launches on the paged plane: each package's contiguous
    prefill cache paginated (the full layer into the pool, the rolling
    layer passed through) and decoded through the identity block table."""
    B, S, launches, Tn = 2, 12, 6, 2
    jcfg, tcfg = _cfgs(spec_tokens=Tn)
    jpaged, tpaged = (dataclasses.replace(c, paged=True, page_size=8) for c in (jcfg, tcfg))
    jm, tm = JModel(jcfg), Model(tcfg, device="cpu")
    jpm, tpm = JModel(jpaged), Model(tpaged, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, bridge(jp), "cpu")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    max_len = S + launches * Tn
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jm.init_cache(B, max_len))
    tc = tm.init_cache(B, max_len)
    tl = tm.prefill(tp, prompts, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL, err_msg="prefill")
    jc = jpm.paginate_cache(jc, max_len)
    tc = tpm.paginate_cache(tc, max_len)
    assert "pk" in tc[0] and "pk" not in tc[1]
    jpages = JT.identity_page_table(jpaged, B, max_len)
    tpages = T.identity_page_table(tpaged, B, max_len)
    jdec = jax.jit(jpm.decode_tokens)
    last = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    lengths = np.full((B,), S, np.int32)
    prev = np.zeros((B,), np.int32)
    for step in range(launches):
        toks = rng.integers(0, jcfg.vocab_size, (B, Tn)).astype(np.int32)
        toks[:, 0] = last
        jlg, jc = jdec(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(prev), pages=jpages)
        tlg = tpm.decode_tokens(tp, tc, toks, lengths, prev, pages=tpages)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL, err_msg=f"launch {step}")
        y = np.asarray(jnp.argmax(jlg, -1))
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), y, err_msg=f"launch {step}")
        # the first draft accepted: the next launch starts one past it
        last = y[:, 1].astype(np.int32)
        lengths += Tn
        prev = np.full((B,), Tn - 1, np.int32)


@pytest.mark.parametrize("plane", ["contiguous", "paged", "paged_tree2x1"])
def test_served_streams_match_reference(plane, monkeypatch):
    """The CLI's synthetic queue (prompts of 12, 10 generated, 4 requests
    over 2 slots) at spec 2 on each plane, and a 2,1 draft tree (spec 4)
    on the paged plane: streams equal the reference replica's."""
    tree = None
    kw = dict(spec_tokens=2)
    if plane != "contiguous":
        kw.update(paged=True, page_size=8)
    if plane == "paged_tree2x1":
        kw["spec_tokens"] = 4
        tree = (JTreePlan.from_branching((2, 1)), TreePlan.from_branching((2, 1)))
    jcfg, tcfg = _cfgs(**kw)
    want, got, rep = reference_and_port_streams(jcfg, tcfg, slots=2, prompt_len=12, gen=10, n_req=4,
                                                monkeypatch=monkeypatch, tree=tree)
    assert got == want
    assert len(got) == 4 and all(len(t) == 11 for t in got.values())
    assert ("pk" in rep.cache[0]) == (plane != "contiguous") and "pk" not in rep.cache[1]


def test_contiguous_plane_refuses_a_branchy_tree_on_the_local_layer():
    """Layer 0 (full attention) runs; layer 1 (the rolling window) refuses
    the tree with the reference's message."""
    _, cfg = _cfgs(spec_tokens=4)
    m = Model(cfg, device="cpu")
    params = m.init(0)
    cache = m.init_cache(1, 24)
    m.prefill(params, np.arange(10)[None], cache)
    with pytest.raises(NotImplementedError, match="branchy draft trees on rolling-window layers"):
        m.decode_tokens(params, cache, np.arange(4)[None], [10], [0], tree=TreePlan.from_branching((2, 1)))
    assert torch.isfinite(cache[0]["k"]).all()
