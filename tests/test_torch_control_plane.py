"""PyTorch port, control plane: plans and routing against the JAX reference.

Inputs come from a numpy seed and go through both packages on the CPU.
Gates: plan integers (expert ids, dispatch/combine indices, flat words) are
EXACTLY equal; f32 weights agree within 1e-6 (softmax sums taken in a
different order move the last ulps only).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import control_plane as jcp
from repro.core.plans import TreePlan as JTree
from repro_torch.core import control_plane as tcp
from repro_torch.core.plans import TreePlan as TTree

W_TOL = 1e-6

# one compile per shape instead of one per eager op
_j_route = jax.jit(jcp.route_topk, static_argnums=(2, 3))
_j_route_decode = jax.jit(jcp.route_topk_decode, static_argnums=(2,))


def _inputs(seed, T, d, E):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((T, d)).astype(np.float32), rng.standard_normal((d, E)).astype(np.float32)


@pytest.mark.parametrize("T,E,k,cf", [(16, 8, 2, 1.25), (37, 16, 4, 0.5), (12, 8, 8, 8.0), (5, 32, 3, 1.0)])
def test_route_topk_plan_matches_reference(T, E, k, cf):
    """Prefill routing, including capacity drops (cf 0.5) and k == E."""
    x, w = _inputs(T * 7 + E, T, 24, E)
    C = tcp.capacity_for(T, E, k, cf)
    assert C == jcp.capacity_for(T, E, k, cf)
    jp, jaux = _j_route(jnp.asarray(x), jnp.asarray(w), k, C)
    tp, taux = tcp.route_topk(torch.from_numpy(x), torch.from_numpy(w), k, C)
    for name in ("dispatch_idx", "dispatch_valid", "combine_idx", "flat_idx", "flat_cidx"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)
    for name in ("combine_w", "slot_w", "flat_cw"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), atol=W_TOL, err_msg=name)
    np.testing.assert_allclose(float(taux.fraction_dropped), float(jaux.fraction_dropped), atol=W_TOL)
    np.testing.assert_allclose(float(taux.load_balance_loss), float(jaux.load_balance_loss), rtol=1e-5)
    np.testing.assert_allclose(float(taux.router_z_loss), float(jaux.router_z_loss), rtol=1e-5)


def test_flat_words_derived_equal_emitted():
    """Plans rebuilt without their flat views derive the same words."""
    x, w = _inputs(3, 20, 16, 8)
    tp, _ = tcp.route_topk(torch.from_numpy(x), torch.from_numpy(w), 2, 8)
    bare = tp._replace(flat_idx=None, slot_w=None, flat_cidx=None, flat_cw=None)
    np.testing.assert_array_equal(bare.flat_dispatch_idx().numpy(), tp.flat_idx.numpy())
    np.testing.assert_array_equal(bare.flat_slot_w().numpy(), tp.slot_w.numpy())


@pytest.mark.parametrize("zero_router", [False, True])
def test_route_topk_decode_matches_reference(zero_router):
    """Decode routing; a zero router is all ties, which jax.lax.top_k
    breaks toward the lower expert index."""
    x, w = _inputs(11, 9, 32, 16)
    if zero_router:
        w = np.zeros_like(w)
    jp = _j_route_decode(jnp.asarray(x), jnp.asarray(w), 4)
    tp = tcp.route_topk_decode(torch.from_numpy(x), torch.from_numpy(w), 4)
    np.testing.assert_array_equal(tp.expert_ids.numpy(), np.asarray(jp.expert_ids))
    np.testing.assert_allclose(tp.weights.numpy(), np.asarray(jp.weights), atol=W_TOL)
    if zero_router:
        np.testing.assert_array_equal(tp.expert_ids.numpy(), np.tile(np.arange(4), (9, 1)))


def test_dispatch_combine_match_reference():
    x, w = _inputs(5, 14, 16, 8)
    rng = np.random.default_rng(6)
    jp, _ = _j_route(jnp.asarray(x), jnp.asarray(w), 2, 4)  # drops at C=4
    tp, _ = tcp.route_topk(torch.from_numpy(x), torch.from_numpy(w), 2, 4)
    np.testing.assert_array_equal(tcp.dispatch(torch.from_numpy(x), tp).numpy(), np.asarray(jax.jit(jcp.dispatch)(jnp.asarray(x), jp)))
    y = rng.standard_normal((8, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tcp.combine(torch.from_numpy(y), tp).numpy(), np.asarray(jax.jit(jcp.combine)(jnp.asarray(y), jp)), atol=1e-6
    )


def test_topk_agreement_matches_reference():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 6, (10, 3)).astype(np.int32)  # duplicates within rows
    b = rng.integers(0, 6, (10, 3)).astype(np.int32)
    want = float(jcp.topk_agreement(jnp.asarray(a), jnp.asarray(b)))
    assert float(tcp.topk_agreement(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(want, abs=1e-7)


@pytest.mark.parametrize("shape", [("chain", 1), ("chain", 4), ("branch", (2, 2)), ("branch", (3, 1, 2))])
def test_tree_plan_matches_reference(shape):
    kind, arg = shape
    jt = JTree.chain(arg) if kind == "chain" else JTree.from_branching(arg)
    tt = TTree.chain(arg) if kind == "chain" else TTree.from_branching(arg)
    assert tt.parents == jt.parents
    assert tt.children() == jt.children()
    assert tt.depths() == jt.depths()
    assert tt.ancestor_words() == jt.ancestor_words()
    assert tt.is_chain() == jt.is_chain()
