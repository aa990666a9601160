"""PyTorch port, model: the Qwen3-MoE decode-plane stack against the JAX
reference's jnp paths (``use_pallas=False``), on the CPU, with the
reference's weights bridged through numpy.

Gates: prefill and decode logits within 1e-5 (f32; the sides sum in
different orders), the cache-carried plan ids EXACTLY equal after every
launch, and greedy tokens identical for 16 launches at spec widths 1 and 4,
rejected drafts (rollback) included.  Configs: the smoke config (top_k ==
E == 8) and a variant with 16 experts top-2, where routing is not vacuous.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager
from repro.checkpoint.manager import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.models.model import Model as JModel
from repro_torch.checkpoint import init_params, load_step_dir, params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.plans import TreePlan
from repro_torch.launch.speculative import draft_tree_ngram
from repro_torch.models.model import Model as TModel

ARCH = "qwen3-moe-235b-a22b"
TOL = 1e-5
VARIANTS = {"smoke": {}, "e16k2": dict(num_experts=16, top_k=2)}


def _configs(variant, Tn):
    kw = dict(decode_plane=True, spec_tokens=Tn, **VARIANTS[variant])
    return dataclasses.replace(j_smoke(ARCH), **kw), dataclasses.replace(t_smoke(ARCH), **kw)


def _bridge(jparams):
    names, leaves, _ = _flatten(jparams)
    return {n: np.asarray(l) for n, l in zip(names, leaves)}


@pytest.mark.parametrize("Tn", [1, 4])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_plane_matches_reference(variant, Tn):
    jcfg, tcfg = _configs(variant, Tn)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu")
    tp = params_from_numpy(tcfg, _bridge(jp), "cpu")
    B, S, max_len = 2, 9, 9 + 16 * Tn + Tn
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)

    jc = jm.init_cache(B, max_len)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jc)
    tc = tm.init_cache(B, max_len)
    tl = tm.prefill(tp, prompts, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)

    jdec = jax.jit(jm.decode_tokens)
    tree = TreePlan.chain(Tn)
    last = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    history = [[int(t)] for t in last]
    # slot 0 drafts from its own sequential greedy stream (every draft is
    # accepted), slot 1 from the ngram drafter (most drafts are rejected)
    oracle = _sequential_stream(tcfg, tp, prompts[0], 16 * Tn + 1, int(last[0])) if Tn > 1 else None
    lengths = np.full((B,), S, np.int32)
    prev = np.zeros((B,), np.int32)
    accepts = []
    for step in range(16):
        toks = np.stack([draft_tree_ngram(history[b], int(last[b]), tree) for b in range(B)]).astype(np.int32)
        if oracle is not None:
            n0 = len(history[0]) - 1
            toks[0] = oracle[n0:n0 + Tn]
        jlg, jc = jdec(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(prev))
        tlg = tm.decode_tokens(tp, tc, toks, lengths, prev)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL, err_msg=f"launch {step}")
        j_plan = np.asarray(jc["scan"]["b0"]["plan_e"])  # (layers, B, [T,] k)
        np.testing.assert_array_equal(np.stack([c["plan_e"].numpy() for c in tc]), j_plan, err_msg=f"launch {step}")
        y = np.asarray(jnp.argmax(jlg, -1))
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), y, err_msg=f"launch {step}")
        for b in range(B):  # greedy verify / rollback
            a = 1
            while a < Tn and toks[b, a] == y[b, a - 1]:
                a += 1
            accepts.append(a)
            history[b].extend(int(t) for t in y[b, :a])
            lengths[b] += a
            prev[b] = a - 1
            last[b] = y[b, a - 1]
    if Tn > 1:  # both branches of verify were exercised, and slot 0 kept the sequential stream
        assert min(accepts) == 1 and max(accepts) == Tn, accepts
        assert history[0] == oracle[: len(history[0])]


def _sequential_stream(tcfg, tp, prompt, n, first):
    """Greedy stream of one prompt at width 1 (the port's own sequential decode)."""
    m = TModel(dataclasses.replace(tcfg, spec_tokens=1), device="cpu")
    cache = m.init_cache(1, len(prompt) + n + 1)
    m.prefill(tp, prompt[None], cache)
    out = [first]
    for i in range(n):
        lg = m.decode_tokens(tp, cache, [[out[-1]]], [len(prompt) + i])
        out.append(int(lg[0, 0].argmax()))
    return out


def test_checkpoint_step_dir_loads_without_jax_tree(tmp_path):
    """A reference CheckpointManager step directory loads through the
    port's manifest reader into the same params as the in-memory bridge."""
    jcfg, tcfg = _configs("e16k2", 1)
    jp = JModel(jcfg).init(jax.random.PRNGKey(3))
    CheckpointManager(tmp_path).save(5, jp, {})
    got = load_step_dir(tcfg, tmp_path / "step_00000005", "cpu")
    want = params_from_numpy(tcfg, _bridge(jp), "cpu")
    flat_got = {k: v for k, v in _leaves(got)}
    flat_want = {k: v for k, v in _leaves(want)}
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        assert torch.equal(flat_got[k], flat_want[k]), k


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_shapes_and_storage_types(dtype):
    """The port's own init draws every leaf the bridge fills, with the same
    shapes, stored in the type its use computes in."""
    jcfg, tcfg = _configs("e16k2", 4)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    own = dict(_leaves(init_params(tcfg, gen, "cpu")))
    bridged = dict(_leaves(params_from_numpy(tcfg, _bridge(JModel(jcfg).init(jax.random.PRNGKey(0))), "cpu")))
    assert own.keys() == bridged.keys()
    for k in own:
        assert own[k].shape == bridged[k].shape and own[k].dtype == bridged[k].dtype, k
    f32 = {k for k, v in own.items() if v.dtype == torch.float32}
    expect = {k for k in own if k.split("/")[-1] in ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "router", "unembed")}
    assert f32 == (set(own) if dtype == "float32" else expect)


def test_admission_prefill_into_slot_equals_b1_cache_copy():
    """Writing a B=1 prefill straight into a slot leaves the slot exactly as
    a fresh B=1 cache copied in (the reference's admission)."""
    _, tcfg = _configs("smoke", 4)
    m = TModel(tcfg, device="cpu")
    p = m.init(0)
    prompt = np.arange(7, dtype=np.int32)[None] % tcfg.vocab_size
    direct = m.init_cache(3, 20)
    m.prefill(p, np.full((1, 12), 5, np.int32), direct, slot=1)  # stale rows from an earlier request
    m.prefill(p, prompt, direct, slot=1)
    one = m.init_cache(1, 20)
    m.prefill(p, prompt, one)
    copied = m.init_cache(3, 20)
    m.write_cache_slot(copied, one, 1)
    for a, b in zip(direct, copied):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_decode_rejects_control_words_outside_the_cache():
    """Positions past the cache and plan rows past the plan vector are
    refused on the host, before any write (on the card an out-of-range
    index would be a device fault)."""
    _, tcfg = _configs("smoke", 2)
    m = TModel(tcfg, device="cpu")
    p = m.init(0)
    cache = m.init_cache(1, 8)
    m.prefill(p, np.arange(4, dtype=np.int32)[None], cache)
    with pytest.raises(ValueError, match="outside the cache"):
        m.decode_tokens(p, cache, [[1, 2]], [7])
    with pytest.raises(ValueError, match="selects no row"):
        m.decode_tokens(p, cache, [[1, 2]], [4], [2])
    assert m.decode_tokens(p, cache, [[1, 2]], [6], [1]).shape == (1, 2, tcfg.vocab_size)
