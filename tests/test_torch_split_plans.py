"""PyTorch port, on the CPU: the shape logic around kernels 6 and 7.

Kernel 6 (``flash_decode_window``) splits each token's visible run over
``window_splits(limit)`` blocks of ``WINDOW_CHUNK`` rows.  The split bounds
live in ``window_split_kernel`` (CUDA), which cannot run here; this file
checks their formula, written out below, against the visibility the JAX
package's window decode defines (Pallas, interpret mode): every visible
position is covered by exactly one split, and no hidden one by any.  The
kernel itself is held to it on the card
(``tests/test_torch_cuda_kernels.py``, ``-m cuda``).  Kernel 7
(``flash_attention``) picks its card build from dtype and head dim; on the
CPU every pair runs the plain version, held here against the JAX package.
"""
from __future__ import annotations

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.kernels.flash_attention import flash_decode_window as j_flash_decode_window
from repro_torch.kernels.flash_attention import flash_attention, ops

CHUNK = ops.WINDOW_CHUNK


def _split_rows(pos: int, head: int, W: int, limit: int):
    """The rows split c of a token takes, by the formula of
    ``window_split_kernel``: ``[first + c*CHUNK, first + (c+1)*CHUNK)``
    clipped to the token's run ``[first, pos]``."""
    first = max(0, pos - limit + 1, head - W + 1)
    for c in range(ops.window_splits(limit)):
        p0 = first + c * CHUNK
        n = max(0, min(CHUNK, pos + 1 - p0))
        yield from range(p0, p0 + n)


def _visible_slots(starts, T: int, W: int, window: int) -> np.ndarray:
    """(B, T, W) bool: the slots token (b, t) attends to under the JAX
    package's window decode.  With q = 0 every score ties, so the output is
    the mean of the visible V rows; V row s is the one-hot of slot s."""
    B = len(starts)
    q = jnp.zeros((B, T, 1, W), jnp.float32)
    k = jnp.zeros((B, W, 1, W), jnp.float32)
    v = jnp.broadcast_to(jnp.eye(W, dtype=jnp.float32)[None, :, None, :], (B, W, 1, W))
    out = j_flash_decode_window(q, k, v, jnp.asarray(starts, jnp.int32), window=window, interpret=True)
    return np.asarray(out)[:, :, 0, :] > 0


@pytest.mark.parametrize("limit,expect", [(2048, 32), (16, 1), (64, 1), (65, 2), (128, 2), (129, 3)])
def test_window_splits_is_ceil_limit_over_chunk(limit, expect):
    assert CHUNK == 64
    assert ops.window_splits(limit) == expect


@pytest.mark.parametrize("T,W,window,starts", [
    (1, 2048, 2048, [0, 63, 2047, 4160]),   # RecurrentGemma's decode, before and after the wrap
    (1, 256, 100, [0, 5, 99, 100, 257]),    # window < W
    (1, 24, 16, [2, 21, 75]),               # one split, wrapped
    (3, 131, 131, [0, 127, 128, 320]),      # T = 3 chains across the wrap
    (3, 200, 150, [2, 148, 199, 451]),      # T = 3, three splits, window < W
    (2, 128, 128, [62, 126, 127, 300]),     # T = 2, runs a multiple of the chunk
])
def test_window_split_formula_covers_each_visible_slot_once(T, W, window, starts):
    """The formula, not the kernel: the CUDA kernel is checked on the card."""
    limit = min(window, W)
    vis = _visible_slots(starts, T, W, window)
    for b, start in enumerate(starts):
        head = start + T - 1
        for t in range(T):
            pos = start + t
            covered = Counter(p % W for p in _split_rows(pos, head, W, limit))
            assert max(covered.values(), default=1) == 1, (start, pos)
            assert set(covered) == set(np.flatnonzero(vis[b, t])), (start, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 160, 256])
def test_flash_attention_every_build_pair_matches_jax_on_cpu(dtype, hd):
    """Each (dtype, head dim) kernel 7 is built for, on the CPU (the plain
    version), against the JAX package's kernel in interpret mode: GQA with a
    group of 10 heads (RecurrentGemma's), a ragged last block and a window
    edge inside a tile.  f32 at 1e-5; bf16 inputs are rounded once on both
    sides, the port's output rounded to bf16: one bf16 ulp (2^-7)."""
    rng = np.random.default_rng(hd)
    S, nq, nkv, window = 37, 10, 1, 21
    q = rng.standard_normal((1, S, nq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((1, S, nkv, hd)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True, window=window).float().numpy()
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (tq, tk, tv))
    want = np.asarray(j_flash_attention(jq, jk, jv, causal=True, window=window, bq=16, bkv=16, interpret=True))
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
