"""PyTorch port, on the CPU: the shape logic around kernels 1, 5 and 8.

Kernels 1 and 5 (``flash_decode``, ``flash_decode_paged``) split each
token's run over ``decode_splits(S)`` blocks, each taking its share of the
``DECODE_CHUNK``-row chunks of the row capacity S.  The split bounds live in
``decode_split_kernel`` (CUDA), which cannot run here; this file checks
their formula, written out below, against the visibility the JAX package's
``flash_decode`` defines (Pallas, interpret mode): every visible row is
covered by exactly one split, and no hidden one by any, for chain and tree
words, below the split cap and above it (where a split walks several
chunks).  Kernel 8 (``grouped_gemm``) picks its card build from (dtype, K, N,
alignment); the plain version every build is held to on the card is held
here against the JAX package's kernel at the tensor-core build's shapes.
The kernels themselves are held on the card (``tests/test_torch_cuda_kernels.py``,
``-m cuda``).
"""
from __future__ import annotations

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plans import TreePlan
from repro.kernels.flash_attention import flash_decode as j_flash_decode
from repro.kernels.grouped_gemm.kernel import grouped_gemm_pallas
from repro_torch.kernels.flash_attention import flash_decode, ops
from repro_torch.kernels.grouped_gemm import grouped_gemm, ops as gg_ops

CHUNK = ops.DECODE_CHUNK


def _split_rows(length: int, S: int, nsplit: int, word: int, base: int):
    """The rows split c of ``nsplit`` gives a token, by the formula of
    ``decode_split_kernel``: chunks ``[c*per, (c+1)*per)`` of the capacity's
    ``nchunk = ceil(S / CHUNK)``, ``per = ceil(nchunk / nsplit)``, each
    clipped to the token's run ``[0, min(length, S))`` and masked by its
    ancestor word above ``base``."""
    L = min(length, S)
    nchunk = -(-S // CHUNK)
    per = -(-nchunk // nsplit)
    for c in range(nsplit):
        for j in range(c * per, min(nchunk, (c + 1) * per)):
            for p in range(j * CHUNK, min((j + 1) * CHUNK, L)):
                u = p - base
                if u < 0 or (word >> min(u, 31)) & 1:
                    yield p


def _visible_rows(lengths: np.ndarray, S: int, words, base) -> np.ndarray:
    """(B, T, S) bool: the rows token (b, t) attends to under the JAX
    package's flash_decode.  With q = 0 every score ties, so the output is
    the mean of the visible V rows; V row s is the one-hot of row s."""
    B, T = lengths.shape
    q = jnp.zeros((B, T, 1, S), jnp.float32)
    k = jnp.zeros((B, S, 1, S), jnp.float32)
    v = jnp.broadcast_to(jnp.eye(S, dtype=jnp.float32)[None, :, None, :], (B, S, 1, S))
    anc = None if words is None else jnp.asarray(words, jnp.int32)
    out = j_flash_decode(q, k, v, jnp.asarray(lengths - 1, jnp.int32), ancestors=anc,
                         base=None if base is None else jnp.asarray(base, jnp.int32), interpret=True)
    return np.asarray(out)[:, :, 0, :] > 0


@pytest.mark.parametrize("S,T,tree,bases", [
    (240, 4, None, [0, 60, 63, 128, 236]),        # chains across every chunk edge, the last at S
    (240, 4, (2, 1), [0, 60, 61, 124, 208]),      # tree 2,1: runs of 1 .. 212 rows
    (100, 3, (1, 1), [0, 62, 97]),                # a ragged last chunk
    (64, 1, None, [0, 62, 63]),                   # one chunk: 1, 63 and 64 rows
    (2112, 1, None, [0, 127, 2047, 2111]),        # 33 chunks over 32 splits: two chunks a split
    (2240, 4, (2, 1), [0, 124, 2100, 2236]),      # 35 chunks, tree 2,1 across a split's two chunks
])
def test_decode_split_formula_covers_each_visible_row_once(S, T, tree, bases):
    """The formula, not the kernel: the CUDA kernel is checked on the card."""
    plan = None if tree is None else TreePlan.from_branching(tree)
    if plan is not None:
        assert plan.num_nodes == T
    words = None if plan is None else plan.ancestor_words()
    base = np.asarray(bases, np.int32)
    lengths = base[:, None] + np.arange(1, T + 1, dtype=np.int32)[None, :]
    vis = _visible_rows(lengths, S, words, None if plan is None else base)
    for b in range(len(bases)):
        for t in range(T):
            word = -1 if words is None else words[t]
            bs = base[b] if plan is not None else 0
            covered = Counter(_split_rows(int(lengths[b, t]), S, ops.decode_splits(S), word, bs))
            assert max(covered.values(), default=1) == 1, (b, t)
            assert set(covered) == set(np.flatnonzero(vis[b, t])), (b, t)


@pytest.mark.parametrize("tree", [None, (2, 1)])
def test_flash_decode_plain_matches_jax_at_chunk_edges(tree):
    """The plain version the card holds kernels 1 and 5 to, against the JAX
    package's flash_decode (interpret mode) at runs of 1, 63, 64, 65, 128,
    212 and 240 rows of a 240-row capacity: f32 at 1e-5."""
    plan = None if tree is None else TreePlan.from_branching(tree)
    T = 4 if plan is None else plan.num_nodes
    S, nq, nkv, hd = 240, 4, 2, 16
    rng = np.random.default_rng(S)
    last = np.array([1, 63, 64, 65, 128, 212, 240])
    base = np.maximum(last - T, 0).astype(np.int32)
    lengths = np.minimum(base[:, None] + np.arange(1, T + 1)[None, :], last[:, None]).astype(np.int32)
    B = len(last)
    q = rng.standard_normal((B, T, nq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, nkv, hd)).astype(np.float32) for _ in range(2))
    words = None if plan is None else np.asarray(plan.ancestor_words(), np.int32)
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(lengths - 1),
                       ancestors=None if words is None else torch.from_numpy(words),
                       base=None if words is None else torch.from_numpy(base))
    want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths - 1),
                          ancestors=None if words is None else jnp.asarray(words),
                          base=None if words is None else jnp.asarray(base), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_grouped_gemm_path_is_tensor_cores_exactly_for_bf16_with_16_byte_strides(dtype):
    # the serving shape and the ragged case the card runs
    assert gg_ops.grouped_gemm_path(dtype, 1536, 4096, True) == (
        "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")
    assert gg_ops.grouped_gemm_path(dtype, 100, 130, True) == "cuda_cores"


@pytest.mark.parametrize("E,M,K,N", [(4, 8, 200, 328), (3, 37, 200, 328), (2, 300, 72, 136), (2, 16, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_plain_matches_pallas_at_tensor_core_shapes(E, M, K, N, dtype):
    """K and N multiples of 8 (not all of 64, so TMA zero-fills on the
    card), M 8, 16, 37 and 300 (the card's M tiles of 16, 64 and 256 rows):
    the plain version against the JAX kernel in interpret mode; f32 at
    1e-5, bf16 one ulp (both sides round one f32 sum)."""
    rng = np.random.default_rng(M + K)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    assert gg_ops.grouped_gemm_path(getattr(torch, dtype), K, N, True) == (
        "tensor_cores" if dtype == "bfloat16" else "cuda_cores")
    got = grouped_gemm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w).to(getattr(torch, dtype)))
    want = np.asarray(grouped_gemm_pallas(jnp.asarray(x, dtype), jnp.asarray(w, dtype), interpret=True)
                      .astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=1e-5)
    else:
        assert np.all(np.abs(got.float().numpy() - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)
