"""PyTorch port, Mamba-2 model: the pure-SSM stack against the JAX
reference's ``Model`` on the CPU, with the reference's weights bridged
through numpy (``blocks/scan/b0/ssm/*`` and ``ln1``, no ``ln2``).

Gates (f32, atol/rtol 1e-5): prefill logits and the SSD state ``h`` and
conv tail of every layer, then every T = 1 decode launch's logits, state
and greedy token, with prompts that cross the smoke chunk of 16 with a
ragged tail; prefill of ``t[:k]`` plus decode of the rest equals prefill
of ``t``; a B=1 admission copied into a slot by ``write_cache_slot``
decodes as that B=1 cache does; T > 1 is refused with the reference's
words.
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
from repro.models.model import Model as JModel
from repro_torch.checkpoint import init_params, params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models.model import Model as TModel

ARCH = "mamba2-2.7b"
TOL = 1e-5


def _bridge(jparams):
    names, leaves, _ = _flatten(jparams)
    return {n: np.asarray(l) for n, l in zip(names, leaves)}


def _configs():
    return (dataclasses.replace(j_smoke(ARCH), decode_plane=True),
            dataclasses.replace(t_smoke(ARCH), decode_plane=True))


def _models():
    jcfg, tcfg = _configs()
    jm, tm = JModel(jcfg), TModel(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, tm, jp, params_from_numpy(tcfg, _bridge(jp), "cpu")


def _assert_state_equal(tc, jc, msg):
    for i, c in enumerate(tc):
        for name, leaf in c.items():
            np.testing.assert_allclose(leaf.float().numpy(), np.asarray(jc["scan"]["b0"][name][i]), atol=TOL,
                                       rtol=TOL, err_msg=f"{msg}: layer {i} {name}")


def test_bridge_carries_ssm_leaves_without_ln2():
    jcfg, tcfg, _, _, jp, tp = _models()
    names = set(_bridge(jp))
    assert "blocks/scan/b0/ssm/w_in" in names and "blocks/scan/b0/ln1" in names
    assert not any("ln2" in n for n in names)
    assert [sorted(layer) for layer in tp["layers"]] == [["ln1", "ssm"]] * tcfg.num_layers
    own = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for mine, bridged in zip(own["layers"], tp["layers"]):
        for k, v in bridged["ssm"].items():
            assert mine["ssm"][k].shape == v.shape and mine["ssm"][k].dtype == v.dtype, k


@pytest.mark.parametrize("S", [3, 37])
def test_prefill_and_decode_match_reference(S):
    """Prompts of 37 tokens (two chunks of 16 and a ragged 5) and of 3 (the
    conv tail's length), 8 greedy T = 1 launches after them."""
    jcfg, tcfg, jm, tm, jp, tp = _models()
    B, steps = 2, 8
    max_len = S + steps + 1
    prompts = np.random.default_rng(S).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jc = jm.init_cache(B, max_len)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jc)
    tc = tm.init_cache(B, max_len)
    tl = tm.prefill(tp, prompts, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _assert_state_equal(tc, jc, "prefill")
    jdec = jax.jit(jm.decode_tokens)
    toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    lengths = np.full((B,), S, np.int32)
    for step in range(steps):
        jlg, jc = jdec(jp, jc, jnp.asarray(toks), jnp.asarray(lengths))
        tlg = tm.decode_tokens(tp, tc, toks, lengths, max_len=max_len)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL, rtol=TOL, err_msg=f"step {step}")
        _assert_state_equal(tc, jc, f"step {step}")
        y = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        np.testing.assert_array_equal(tlg.argmax(-1).numpy(), y, err_msg=f"step {step}")
        toks = y
        lengths += 1


def test_prefill_then_decode_equals_prefill_of_the_whole_sequence():
    """Prefill t[:k] (k = 19, a chunk and a ragged 3) and decode t[k:] one
    token per launch: every launch's logits equal the last-position logits
    of a prefill of the sequence so far (the recurrent state carries the
    whole prefix); a B=1 admission copied into slot 1 by
    ``write_cache_slot`` decodes the same."""
    _, tcfg, _, tm, _, tp = _models()
    t = np.random.default_rng(4).integers(0, tcfg.vocab_size, 30).astype(np.int32)
    k, max_len = 19, 32
    one = tm.init_cache(1, max_len)
    tm.prefill(tp, t[None, :k], one)
    pool = tm.init_cache(2, max_len)
    TModel.write_cache_slot(pool, one, 1)
    for i in range(k, len(t)):
        got = tm.decode_tokens(tp, one, [[t[i]]], [i], max_len=max_len)[0, 0]
        slot = tm.decode_tokens(tp, pool, [[0], [t[i]]], [0, i], max_len=max_len)[1, 0]
        want = tm.prefill(tp, t[None, :i + 1], tm.init_cache(1, max_len))[0]
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL, msg=f"position {i}")
        torch.testing.assert_close(slot, got, atol=TOL, rtol=TOL, msg=f"slot, position {i}")


def test_ssm_layers_refuse_multi_token_launches():
    _, tcfg = _configs()
    m = TModel(tcfg, device="cpu")
    p = m.init(0)
    cache = m.init_cache(1, 32)
    m.prefill(p, np.arange(5, dtype=np.int32)[None], cache)
    with pytest.raises(NotImplementedError, match="multi-token decode for 'ssm' layers needs a T-step state "
                                                  "recurrence; serve rec/ssm archs with spec_tokens=1"):
        m.decode_tokens(p, cache, [[1, 2]], [5])
    with pytest.raises(ValueError, match="outside the cache of 5 rows"):
        m.decode_tokens(p, cache, [[1]], [5], max_len=5)


def test_ssm_stack_refuses_the_paged_plane():
    """The paged plane takes an ``ssm`` stack as the reference does: its
    SSD state stays unpaged (no pool), and what it still refuses there is
    a multi-token (tree) launch."""
    _, tcfg = _configs()
    m = TModel(dataclasses.replace(tcfg, paged=True), device="cpu")
    cache = m.init_cache(1, 32)
    assert [sorted(c) for c in cache] == [["conv", "h"]] * tcfg.num_layers
    p = m.init(0)
    m.prefill(p, np.arange(5, dtype=np.int32)[None], cache)
    with pytest.raises(NotImplementedError, match="serve rec/ssm archs with spec_tokens=1"):
        m.decode_tokens(p, cache, [[1, 2]], [5], max_len=32)
