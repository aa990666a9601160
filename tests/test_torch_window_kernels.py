"""PyTorch port, window decode and prefill attention: the plain versions of
kernels 6 (``flash_decode_window``) and 7 (``flash_attention``) against the
reference's Pallas kernels in interpret mode and its jnp oracles, on the CPU.

Gates (atol 1e-5, f32; the sides sum in different orders): window decode
before the first wrap, at position W - 1, after several wraps, over a
ragged batch, at T = 1 and T = 3 (the drafts of a chain overwrite slots the
earlier tokens' windows no longer need); prefill attention causal and
windowed, MQA and GQA, with a ragged last block.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.kernels.flash_attention import flash_decode_window as j_flash_decode_window
from repro.models.layers import blockwise_attention as j_blockwise
from repro_torch.kernels.flash_attention import flash_attention, flash_decode_window, ops

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _decode_case(seed, B, T, nq, nkv, hd, W):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in ((B, T, nq, hd), (B, W, nkv, hd), (B, W, nkv, hd)))


# (positions of token (b, 0), T, W buffer slots, window): before the first
# wrap, at W - 1, after several wraps, ragged across the batch
DECODE_CASES = {
    "before_wrap": ([3, 9], 1, 16, 16),
    "at_w_minus_1": ([15, 15], 1, 16, 16),
    "several_wraps": ([70, 101], 1, 16, 16),
    "ragged": ([0, 15, 16, 53], 1, 16, 16),
    "window_below_buffer": ([40, 7, 16], 1, 16, 10),
    "chain_t3_before_wrap": ([2, 5], 3, 24, 16),
    "chain_t3_at_wrap": ([21, 22, 23], 3, 24, 16),
    "chain_t3_several_wraps": ([75, 100, 49], 3, 24, 16),
    "chain_t3_no_slack": ([30, 8], 3, 16, 16),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("nq,nkv", [(4, 1), (4, 2)])
def test_plain_window_decode_matches_pallas_interpret(case, nq, nkv):
    idx, T, W, window = DECODE_CASES[case]
    B, hd = len(idx), 16
    q, k, v = _decode_case(len(case) + nq * nkv, B, T, nq, nkv, hd, W)
    idx = np.asarray(idx, np.int32)
    got = flash_decode_window(_t(q), _t(k), _t(v), _t(idx), window=window)
    want = j_flash_decode_window(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx), window=window,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_window_decode_scalar_index_and_checks():
    q, k, v = _decode_case(0, 2, 1, 4, 1, 16, 8)
    got = flash_decode_window(_t(q), _t(k), _t(v), 12, window=8)
    want = j_flash_decode_window(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(12), window=8,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    q9, k9, v9 = _decode_case(0, 1, 9, 4, 1, 16, 8)
    with pytest.raises(ValueError, match="overwrite its own slots"):
        flash_decode_window(_t(q9), _t(k9), _t(v9), 0, window=8)
    with pytest.raises(ValueError, match="int8"):  # scales with a full-precision buffer
        flash_decode_window(_t(q), _t(k), _t(v), 3, window=8, scales=torch.ones(2, 2, 8))
    pos = torch.tensor([3, 4], dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        ops.flash_decode_window_kernel(_t(q), _t(k), _t(v), pos, window=8)


# (B, S, nq, nkv, hd, causal, window): MQA and GQA, causal and windowed,
# S not a multiple of the reference kernel's 16-row blocks
PREFILL_CASES = {
    "mqa_causal_window": (1, 37, 4, 1, 16, True, 8),
    "gqa_causal": (2, 37, 4, 2, 16, True, 0),
    "gqa_window_wide": (2, 45, 6, 3, 32, True, 16),
    "mha_noncausal": (1, 21, 2, 2, 16, False, 0),
    "mqa_window_1": (1, 19, 4, 1, 16, True, 1),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_plain_flash_attention_matches_pallas_interpret_and_blockwise(case):
    B, S, nq, nkv, hd, causal, window = PREFILL_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((B, S, nq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, nkv, hd)).astype(np.float32) for _ in range(2))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kern = j_flash_attention(jq, jk, jv, causal=causal, window=window, bq=16, bkv=16, interpret=True)
    oracle = j_blockwise(jq, jk, jv, causal=causal, local_window=window, block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=TOL, rtol=TOL)
