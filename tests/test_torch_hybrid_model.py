"""PyTorch port, hybrid model: RecurrentGemma (RG-LRU + local attention over
rolling-window caches) against the JAX reference's jnp paths, on the CPU,
with the reference's weights bridged through numpy.

Gates: prefill and decode logits within 1e-5 (f32; the sides sum in
different orders, and the reference scans associatively where the port
loops), the rolling K/V buffers and the ``rec`` state ``h``/``conv`` equal
to the reference's within 1e-5 after every step, greedy tokens identical
for 18 steps with prompts longer than the smoke window of 16 (every buffer
wraps).  A 5-layer cut exercises the bridge's ``blocks/rest`` tail, and a
T = 3 chain on the Qwen3-MoE smoke config with ``attention_kind="local"``
exercises multi-token launches on rolling buffers.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import shrink as j_shrink
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch.checkpoint import init_params, params_from_numpy
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs import shrink as t_shrink
from repro_torch.launch.speculative import draft_tree_ngram
from repro_torch.core.plans import TreePlan
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel

ARCH = "recurrentgemma-2b"
TOL = 1e-5


def _bridge(jparams):
    names, leaves, _ = _flatten(jparams)
    return {n: np.asarray(l) for n, l in zip(names, leaves)}


def _configs(layers=None, **kw):
    if layers is None:
        jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    else:
        jcfg, tcfg = j_shrink(j_full(ARCH), num_layers=layers), t_shrink(t_full(ARCH), num_layers=layers)
    kw = dict(decode_plane=True, **kw)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _ref_leaf(jc, cfg, i, name):
    """Layer i's cache leaf ``name`` in the reference's scan/rest layout."""
    P = len(cfg.block_pattern)
    n_sb = cfg.num_layers // P
    s, j = divmod(i, P)
    if s < n_sb:
        return np.asarray(jc["scan"][f"b{j}"][name][s])
    return np.asarray(jc["rest"][i - n_sb * P][name])


def _assert_caches_equal(tc, jc, cfg, msg):
    for i, c in enumerate(tc):
        for name, leaf in c.items():
            np.testing.assert_allclose(leaf.float().numpy(), _ref_leaf(jc, cfg, i, name), atol=TOL, rtol=TOL,
                                       err_msg=f"{msg}: layer {i} {name}")


def _run(jcfg, tcfg, B, S, steps, seed=1):
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, _bridge(jp), "cpu")
    max_len = S + steps + 1
    prompts = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jc = jm.init_cache(B, max_len)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jc)
    tc = tm.init_cache(B, max_len)
    tl = tm.prefill(tp, prompts, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _assert_caches_equal(tc, jc, tcfg, "prefill")
    jdec = jax.jit(jm.decode_tokens)
    toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    lengths = np.full((B,), S, np.int32)
    for step in range(steps):
        jlg, jc = jdec(jp, jc, jnp.asarray(toks), jnp.asarray(lengths))
        tlg = tm.decode_tokens(tp, tc, toks, lengths, max_len=max_len)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL, err_msg=f"step {step}")
        _assert_caches_equal(tc, jc, tcfg, f"step {step}")
        y = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), y, err_msg=f"step {step}")
        toks = y
        lengths += 1
    return tc


def test_smoke_prefill_decode_and_state_match_reference():
    """3 layers (rec, rec, attn), prompts of 30 tokens past the window of 16,
    18 greedy steps: every step's logits, tokens, rolling K/V buffers and
    RG-LRU state agree with the reference."""
    jcfg, tcfg = _configs()
    tc = _run(jcfg, tcfg, B=2, S=30, steps=18)
    assert [tuple(c) for c in tc] == [("h", "conv"), ("h", "conv"), ("k", "v")]
    assert tc[2]["k"].shape[1] == tcfg.local_window  # the buffer is the window, not max_len


def test_short_prompt_inside_the_window_matches_reference():
    """A 3-token prompt, as long as the conv tail (K - 1): the buffer fills
    from slot 0 and wraps during decode.  (Shorter prompts change the
    reference's conv-state shape; the port zero-pads the tail instead.)"""
    jcfg, tcfg = _configs()
    _run(jcfg, tcfg, B=1, S=3, steps=18, seed=4)


def test_five_layers_exercise_the_bridge_rest_branch():
    """5 layers over (rec, rec, attn): one super-block and a tail of two
    ``rec`` layers, bridged from ``blocks/rest/0..1``."""
    jcfg, tcfg = _configs(layers=5)
    p = jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0))
    arrays = _bridge(p)
    assert any(n.startswith("blocks/rest/1/rec/") for n in arrays)
    assert tcfg.layer_kinds == ("rec", "rec", "attn", "rec", "rec")
    _run(jcfg, tcfg, B=2, S=20, steps=4, seed=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_shapes_and_storage_types(dtype):
    """The port's own init draws every leaf the bridge fills, with the same
    shapes, stored in the type its use computes in: the RG-LRU gates stay
    f32 in a bf16 model, and the tied embedding gets one f32 logits table."""
    jcfg, tcfg = _configs(layers=5)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    own = dict(_leaves(init_params(tcfg, torch.Generator().manual_seed(0), "cpu")))
    bridged = dict(_leaves(params_from_numpy(tcfg, _bridge(JModel(jcfg).init(jax.random.PRNGKey(0))), "cpu")))
    assert own.keys() == bridged.keys()
    for k in own:
        assert own[k].shape == bridged[k].shape and own[k].dtype == bridged[k].dtype, k
    f32 = {k for k, v in own.items() if v.dtype == torch.float32}
    gates = ("alpha_r", "b_r", "alpha_i", "b_i", "lam", "ln1", "ln2", "final_norm", "unembed")
    assert f32 == (set(own) if dtype == "float32" else {k for k in own if k.split("/")[-1] in gates})
    for params in (own, bridged):
        assert torch.equal(params["/unembed"], params["/embed"].float())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_rec_layers_refuse_multi_token_launches():
    _, tcfg = _configs()
    m = TModel(tcfg, device="cpu")
    p = m.init(0)
    cache = m.init_cache(1, 32)
    m.prefill(p, np.arange(5, dtype=np.int32)[None], cache)
    with pytest.raises(NotImplementedError, match="spec_tokens=1"):
        m.decode_tokens(p, cache, [[1, 2]], [5])


def test_rolling_layer_chain_matches_reference_layer():
    """Built as the reference's ``test_rolling_spec_layer_kernel_matches_jnp_path``:
    one attention layer, a random 8-slot buffer, lengths [5, 11] (one slot
    before the wrap, one past it), a 3-token chain; output and buffer agree
    with the reference's jnp and window-kernel (interpret) paths."""
    W, B, Tn = 8, 2, 3
    jcfg = {up: dataclasses.replace(j_smoke("qwen3-moe-235b-a22b"), attention_kind="local", local_window=W,
                                    decode_plane=True, spec_tokens=Tn, use_pallas=up) for up in (False, True)}
    tcfg = dataclasses.replace(t_smoke("qwen3-moe-235b-a22b"), attention_kind="local", local_window=W,
                               decode_plane=True, spec_tokens=Tn)
    p = JT.init_layer(jax.random.PRNGKey(0), "attn", jcfg[False], jnp.float32)
    rng = np.random.default_rng(2)
    xn = rng.standard_normal((B, Tn, tcfg.d_model)).astype(np.float32)
    shape = (B, W, tcfg.num_kv_heads, tcfg.resolved_head_dim)
    kv = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    lengths = np.asarray([5, 11], np.int32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p["attn"].items()}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in kv.items()}
    got = TT._decode_attn_rolling(torch.from_numpy(xn), tp, tcfg, tcache, torch.from_numpy(lengths).long(), W)
    for up, cfg in jcfg.items():
        want, jc = JT._decode_attn_rolling_spec(jnp.asarray(xn), p["attn"], cfg, {n: jnp.asarray(a) for n, a in
                                                                                  kv.items()}, jnp.asarray(lengths), W)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL, err_msg=f"use_pallas={up}")
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jc[n]), atol=TOL, rtol=TOL)


def test_moe_local_attention_chain_t3_matches_reference():
    """The Qwen3-MoE smoke stack with ``attention_kind="local"`` (window 16)
    at spec width 3: rolling buffers of window + 8 slack rows, prompts of 20
    tokens, 10 launches with one slot drafting its own greedy stream (every
    draft accepted) and one drafting by ngram (mostly rejected: rollback on
    a rolling buffer); logits, plan ids and buffers agree every launch."""
    Tn = 3
    kw = dict(decode_plane=True, spec_tokens=Tn, attention_kind="local", local_window=16)
    jcfg = dataclasses.replace(j_smoke("qwen3-moe-235b-a22b"), **kw)
    tcfg = dataclasses.replace(t_smoke("qwen3-moe-235b-a22b"), **kw)
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, _bridge(jp), "cpu")
    B, S, launches = 2, 20, 10
    max_len = S + Tn * launches + Tn
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jc = jm.init_cache(B, max_len)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jc)
    tc = tm.init_cache(B, max_len)
    tl = tm.prefill(tp, prompts, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    assert tc[0]["k"].shape[1] == 16 + 8
    # slot 0's drafts: its own greedy stream from a width-1 port model
    seq = TModel(dataclasses.replace(tcfg, spec_tokens=1), device="cpu")
    sc = seq.init_cache(1, max_len)
    oracle = [int(seq.prefill(tp, prompts[:1], sc)[0].argmax())]
    for i in range(Tn * launches + 1):
        oracle.append(int(seq.decode_tokens(tp, sc, [[oracle[-1]]], [S + i])[0, 0].argmax()))
    jdec = jax.jit(jm.decode_tokens)
    tree = TreePlan.chain(Tn)
    last = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    history = [[int(t)] for t in last]
    lengths = np.full((B,), S, np.int32)
    prev = np.zeros((B,), np.int32)
    accepts = []
    for step in range(launches):
        toks = np.stack([draft_tree_ngram(history[b], int(last[b]), tree) for b in range(B)]).astype(np.int32)
        n0 = len(history[0]) - 1
        toks[0] = oracle[n0:n0 + Tn]
        jlg, jc = jdec(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(prev))
        tlg = tm.decode_tokens(tp, tc, toks, lengths, prev)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL, err_msg=f"launch {step}")
        np.testing.assert_array_equal(np.stack([c["plan_e"].numpy() for c in tc]),
                                      np.asarray(jc["scan"]["b0"]["plan_e"]), err_msg=f"launch {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(np.stack([c[name].numpy() for c in tc]), np.asarray(jc["scan"]["b0"][name]),
                                       atol=TOL, rtol=TOL, err_msg=f"launch {step} {name}")
        y = np.asarray(jnp.argmax(jlg, -1))
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), y, err_msg=f"launch {step}")
        for b in range(B):
            a = 1
            while a < Tn and toks[b, a] == y[b, a - 1]:
                a += 1
            accepts.append(a)
            history[b].extend(int(t) for t in y[b, :a])
            lengths[b] += a
            prev[b] = a - 1
            last[b] = y[b, a - 1]
    assert min(accepts) == 1 and max(accepts) == Tn, accepts
    assert history[0] == oracle[: len(history[0])]
    assert lengths.max() > tc[0]["k"].shape[1]  # the buffers wrapped
