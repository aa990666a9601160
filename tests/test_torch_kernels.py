"""PyTorch port, kernels: the plain versions against the JAX oracles on the
CPU, and the wrappers' contracts (each CUDA kernel is held against its plain
version on the card in ``test_torch_cuda_kernels.py``).

Oracles: ``flash_decode`` is held against the reference's Pallas kernel in
interpret mode; the MoE kernels against the reference's ``ref.py`` (its
Pallas kernels need ``pl.load``, which the installed jax lacks).
Tolerances: f32 everywhere on the CPU, 1e-5 absolute — the two sides sum in
different orders, nothing else differs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.control_plane import route_topk
from repro.core.plans import TreePlan
from repro.kernels.flash_attention import flash_decode as j_flash_decode
from repro.kernels.moe_decode import ref as j_moe_decode
from repro.kernels.moe_fused import ref as j_moe_fused
from repro_torch.kernels import kernel_wrappers, reset_launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_decode import ops as md_ops
from repro_torch.kernels.moe_decode import ref as md_ref
from repro_torch.kernels.moe_fused import ops as mf_ops
from repro_torch.kernels.moe_fused import ref as mf_ref

TOL = 1e-5

# jitted oracles: one compile per shape instead of one per eager op
_j_route = jax.jit(route_topk, static_argnums=(2, 3))
_j_gather_swiglu = jax.jit(j_moe_fused.gather_swiglu)
_j_down_combine = jax.jit(j_moe_fused.down_combine, static_argnums=(4,))
_j_moe_apply = jax.jit(j_moe_fused.moe_apply)
_j_decode_moe = jax.jit(j_moe_decode.decode_moe)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------


def _decode_case(seed, B, T, nq, nkv, hd, S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, nq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "B,T,nq,nkv,hd,S,index",
    [
        (2, 1, 4, 4, 16, 32, [5, 31]),         # one token, ragged lengths, S a block multiple
        (2, 3, 4, 2, 16, 40, [0, 30]),         # chain of 3, GQA 2, S = 40 not a multiple of 16
        (1, 4, 8, 2, 8, 19, [15]),             # GQA 4, S < one block
    ],
)
def test_flash_decode_plain_matches_pallas_interpret(B, T, nq, nkv, hd, S, index):
    q, k, v = _decode_case(B * 100 + S, B, T, nq, nkv, hd, S)
    idx = np.asarray(index, np.int32)
    want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx), bkv=16, interpret=True)
    got = fa_ops.flash_decode(_t(q), _t(k), _t(v), _t(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_flash_decode_tree_words_match_pallas_interpret():
    """Hand-made tree (a spine with siblings): draft rows are masked by the
    ancestor words, rows below base stay shared."""
    tree = TreePlan.from_branching((2, 1, 1))
    T = tree.num_nodes
    B, nq, nkv, hd, S = 2, 4, 2, 16, 48
    q, k, v = _decode_case(7, B, T, nq, nkv, hd, S)
    base = np.asarray([9, 30], np.int32)
    idx = (base[:, None] + np.arange(T, dtype=np.int32)[None, :]).astype(np.int32)
    words = np.asarray(tree.ancestor_words(), np.int32)
    want = j_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(idx),
        ancestors=jnp.asarray(words), base=jnp.asarray(base), bkv=16, interpret=True,
    )
    got = fa_ops.flash_decode(_t(q), _t(k), _t(v), _t(idx), ancestors=_t(words), base=_t(base))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # the words matter: the same launch as a chain attends differently
    chain = fa_ops.flash_decode(_t(q), _t(k), _t(v), _t(idx))
    assert not np.allclose(chain.numpy(), got.numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# decode MoE
# ---------------------------------------------------------------------------


def _moe_stacks(seed, E, d, f):
    rng = np.random.default_rng(seed)
    wg = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)
    return wg, wu, wd


@pytest.mark.parametrize("T,k,E", [(3, 2, 8), (4, 2, 8), (6, 8, 8)])
def test_decode_moe_plain_matches_reference(T, k, E):
    """Both forms of the reference oracle: gather (T*k < E) and
    combine-matrix (T*k >= E, including k == E as in the smoke config)."""
    d, f = 32, 48
    rng = np.random.default_rng(T * 10 + k)
    x = rng.standard_normal((T, d)).astype(np.float32)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    wg, wu, wd = _moe_stacks(E, E, d, f)
    want = _j_decode_moe(*(jnp.asarray(a) for a in (x, ids, w, wg, wu, wd)))
    got = md_ref.decode_moe(*(_t(a) for a in (x, ids, w, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_decode_moe_repeated_expert_ids():
    """A row may name one expert twice (hand-built plans): both count."""
    d, f, E = 16, 24, 4
    x = np.random.default_rng(0).standard_normal((2, d)).astype(np.float32)
    ids = np.asarray([[1, 1], [3, 0]], np.int32)
    w = np.asarray([[0.25, 0.75], [0.5, 0.5]], np.float32)
    wg, wu, wd = _moe_stacks(1, E, d, f)
    want = _j_decode_moe(*(jnp.asarray(a) for a in (x, ids, w, wg, wu, wd)))
    got = md_ref.decode_moe(*(_t(a) for a in (x, ids, w, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# fused prefill MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,E,k,C", [(24, 8, 2, 8), (24, 8, 2, 3), (10, 4, 4, 16)])
def test_fused_moe_plain_matches_reference(T, E, k, C):
    """gather_swiglu and down_combine on the same plan words, including
    dropped assignments (C = 3 is below need)."""
    d, f = 16, 40
    rng = np.random.default_rng(T + C)
    x = rng.standard_normal((T, d)).astype(np.float32)
    router = rng.standard_normal((d, E)).astype(np.float32)
    plan, _ = _j_route(jnp.asarray(x), jnp.asarray(router), k, C)
    idx, sw = np.asarray(plan.flat_idx), np.asarray(plan.slot_w)
    wg, wu, wd = _moe_stacks(3, E, d, f)
    jh = _j_gather_swiglu(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(wg), jnp.asarray(wu))
    th = mf_ref.gather_swiglu(_t(x), _t(idx), _t(wg), _t(wu))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)
    jy = _j_down_combine(jh, jnp.asarray(wd), jnp.asarray(idx), jnp.asarray(sw), T)
    ty = mf_ref.down_combine(th, _t(wd), _t(idx), _t(sw), T)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    full = mf_ops.fused_moe_apply(_t(x), _t(idx), _t(sw), _t(wg), _t(wu), _t(wd))
    np.testing.assert_allclose(full.numpy(), np.asarray(_j_moe_apply(
        *(jnp.asarray(a) for a in (x, idx, sw, wg, wu, wd)))), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# wrapper contracts
# ---------------------------------------------------------------------------


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    reset_launch_counts()
    q, k, v = _decode_case(0, 1, 2, 4, 2, 8, 16)
    fa_ops.flash_decode(_t(q), _t(k), _t(v), 3)
    d, f, E = 8, 16, 4
    wg, wu, wd = _moe_stacks(0, E, d, f)
    x = torch.zeros((2, d))
    md_ops.decode_moe_kernel(x, torch.zeros((2, 2), dtype=torch.int32), torch.ones((2, 2)), _t(wg), _t(wu), _t(wd))
    idx = torch.full((E * 8,), 2, dtype=torch.int32)
    h = mf_ops.gather_swiglu(x, idx, _t(wg), _t(wu))
    mf_ops.down_combine(h, _t(wd), idx, torch.zeros(E * 8), 2)
    assert {name: w.launches for name, w in kernel_wrappers().items()} == dict.fromkeys(kernel_wrappers(), 0)


def test_int8_branches_wait_for_a_later_slice():
    q, k, v = _decode_case(0, 1, 1, 4, 2, 8, 16)
    with pytest.raises(NotImplementedError):
        fa_ops.flash_decode(_t(q), _t(k), _t(v), 3, scales=torch.ones((2, 1, 16)))
    wg, wu, wd = _moe_stacks(0, 4, 8, 16)
    with pytest.raises(NotImplementedError):
        md_ops.decode_moe_kernel(torch.zeros((1, 8)), torch.zeros((1, 2), dtype=torch.int32), torch.ones((1, 2)),
                                 _t(wg), _t(wu), _t(wd), scales=torch.ones((3, 4)))


def test_wrappers_reject_bad_operands():
    q, k, v = _decode_case(0, 1, 1, 4, 2, 8, 16)
    with pytest.raises(ValueError):
        fa_ops.flash_decode_kernel(_t(q), _t(k), _t(v), torch.ones(1, dtype=torch.int64))  # lengths not int32
    with pytest.raises(ValueError):
        fa_ops.flash_decode(_t(q), _t(k).double(), _t(v).double(), 3)  # mixed dtypes
    wg, wu, wd = _moe_stacks(0, 4, 8, 16)
    with pytest.raises(ValueError):
        mf_ops.down_combine(torch.zeros((4, 8, 16)), _t(wd), torch.zeros(31, dtype=torch.int32), torch.zeros(31), 2)
