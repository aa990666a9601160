"""PyTorch port, paged flash-decode: the wrapper on CPU tensors (its plain
version) against the reference's Pallas kernel ``flash_decode_paged`` in
interpret mode, and the identity-table contract.

Inputs come from numpy with a seed: a scrambled block table with ``-1``
past each sequence's last valid page, page sizes 8 and 16, chain and tree
ancestor words, f32.  Tolerance 1e-5 absolute: the two sides sum in
different orders, nothing else differs.  With an identity table the plain
paged version is BITWISE the plain contiguous version (the reference's own
contract for its kernels).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.decode import flash_decode_paged as j_flash_decode_paged
from repro_torch.core.plans import TreePlan
from repro_torch.kernels import kernel_wrappers, reset_launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops

TOL = 1e-5
B, NQ, NKV, HD, MP = 3, 8, 2, 16, 5


def _case(seed, T, ps, base):
    """q, a pool of P pages, and a scrambled table: sequence b's valid
    pages are drawn from a permutation, its pages past its clamp are -1."""
    rng = np.random.default_rng(seed)
    n_pages = B * MP + 2
    q = rng.standard_normal((B, T, NQ, HD)).astype(np.float32)
    k = rng.standard_normal((n_pages * ps, NKV, HD)).astype(np.float32)
    v = rng.standard_normal((n_pages * ps, NKV, HD)).astype(np.float32)
    table = rng.permutation(n_pages)[: B * MP].reshape(B, MP).astype(np.int32)
    for b in range(B):
        table[b, (base[b] + T - 1) // ps + 1:] = -1
    return q, k, v, table


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("shape", ["chain", "tree"])
def test_flash_decode_paged_plain_matches_pallas_interpret(ps, shape):
    tree = TreePlan.chain(4) if shape == "chain" else TreePlan.from_branching((2, 1, 1))
    T = tree.num_nodes
    base = np.asarray([0, 13, MP * ps - T], np.int32)
    q, k, v, table = _case(ps + T, T, ps, base)
    idx = (base[:, None] + np.arange(T, dtype=np.int32)[None, :]).astype(np.int32)
    kw, tkw = {}, {}
    if shape == "tree":
        words = np.asarray(tree.ancestor_words(), np.int32)
        kw = dict(ancestors=jnp.asarray(words), base=jnp.asarray(base))
        tkw = dict(ancestors=torch.from_numpy(words), base=torch.from_numpy(base))
    want = j_flash_decode_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
                                jnp.asarray(table), page_size=ps, interpret=True, **kw)
    reset_launch_counts()
    got = fa_ops.flash_decode_paged(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(idx), torch.from_numpy(table), page_size=ps, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert kernel_wrappers()["flash_decode_paged"].launches == 0  # CPU tensors: the plain version ran


@pytest.mark.parametrize("ps", [8, 16])
def test_identity_table_is_bitwise_the_contiguous_plain_version(ps):
    tree = TreePlan.from_branching((2, 1))
    T = tree.num_nodes
    S = MP * ps
    rng = np.random.default_rng(ps)
    q = torch.from_numpy(rng.standard_normal((B, T, NQ, HD)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, NKV, HD)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, NKV, HD)).astype(np.float32))
    base = torch.tensor([2, 17, S - T], dtype=torch.int32)
    table = torch.arange(B * MP, dtype=torch.int32).reshape(B, MP)
    words = torch.tensor(tree.ancestor_words(), dtype=torch.int32)
    for kw in ({}, dict(ancestors=words, base=base)):
        want = fa_ops.flash_decode(q, k, v, base, **kw)
        got = fa_ops.flash_decode_paged(q, k.reshape(B * S, NKV, HD), v.reshape(B * S, NKV, HD), base, table,
                                        page_size=ps, **kw)
        assert torch.equal(got, want)


def test_paged_wrapper_rejects_bad_operands():
    q = torch.zeros((2, 3, 4, 8))
    pool = torch.zeros((32, 2, 8))
    lengths = torch.ones((6,), dtype=torch.int32)
    table = torch.zeros((2 * 4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="pool shape"):
        fa_ops.flash_decode_paged_kernel(q, torch.zeros((32, 2, 4)), pool, lengths, table, page_size=8)
    with pytest.raises(ValueError, match="table"):
        fa_ops.flash_decode_paged_kernel(q, pool, pool, lengths, table[:7], page_size=8)
    with pytest.raises(ValueError, match="lengths"):
        fa_ops.flash_decode_paged_kernel(q, pool, pool, lengths.long(), table, page_size=8)
    with pytest.raises(ValueError, match="int8"):  # scales with a full-precision pool
        fa_ops.flash_decode_paged(q, pool, pool, 0, table.reshape(2, 4), page_size=8, scales=torch.ones(2, 32))
