"""PyTorch port, the expert-parallel plane's kernels and control words on the
CPU: the plain versions of dispatch, combine and the grouped GEMM against the
reference's Pallas kernels in interpret mode (``dispatch_pallas``,
``combine_pallas``, ``grouped_gemm_pallas``), ``fused_experts_fn`` against
the reference's ``local_experts_fn``, and ``DecodePlan.shard_slice`` /
``DispatchPlan.replace_combine`` against the reference.

Tolerances: dispatch bitwise (a copy); combine 1e-6 (f32: k products summed
in another order); grouped GEMM 1e-5 relative (f32 products over K <= 100);
bf16 outputs one bf16 ulp (both sides sum in f32 and round once);
``fused_experts_fn`` 1e-5 (f32, two chained products); integer control
words exactly equal.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.control_plane import route_topk_decode as j_route_decode
from repro.core.plans import DecodePlan as JDecodePlan
from repro.core.plans import DispatchPlan as JDispatchPlan
from repro.kernels.grouped_gemm.kernel import grouped_gemm_pallas
from repro.kernels.grouped_gemm.ops import grouped_swiglu as j_grouped_swiglu
from repro.kernels.moe_dispatch.kernel import combine_pallas, dispatch_pallas
from repro.models.moe import local_experts_fn
from repro_torch.core.control_plane import route_topk
from repro_torch.core.plans import DecodePlan
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels.moe_fused import fused_experts_fn


def _t(a):
    return torch.from_numpy(np.array(a))


def _plan(T, d, E, k, C, seed, skew=False):
    """A dispatch plan from the port's router (the router itself is held
    against the reference in test_torch_control_plane.py); ``skew`` makes
    experts 0 and 1 win every token, so they overflow (drops) and the rest
    stay short (empty slots)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((d, E))).astype(np.float32)
    if skew:
        x[:, 0], w[0, :2] = 4.0, 2.0
    plan, _ = route_topk(_t(x), _t(w), k, C)
    return x, plan


# T, d, E, k, C: empty slots everywhere; drops at C 3; ragged d; the skewed
# router both at once
CASES = [(24, 64, 8, 2, 8, False), (24, 36, 8, 2, 3, False), (37, 100, 8, 2, 5, True), (10, 128, 4, 4, 16, False)]


@pytest.mark.parametrize("T,d,E,k,C,skew", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_plain_matches_pallas_interpret(T, d, E, k, C, skew, dtype):
    x, plan = _plan(T, d, E, k, C, T + C, skew)
    if skew:
        assert (plan.combine_idx < 0).any() and not plan.dispatch_valid.all()
    xt = _t(x).to(getattr(torch, dtype))
    got = md.dispatch(xt, plan)
    x_pad = jnp.concatenate([jnp.asarray(x, dtype), jnp.zeros((1, d), dtype)])
    want = dispatch_pallas(x_pad, jnp.asarray(plan.flat_dispatch_idx().numpy()), num_experts=E, capacity=C,
                           interpret=True)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert md.dispatch.launches == 0


@pytest.mark.parametrize("T,d,E,k,C,skew", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_plain_matches_pallas_interpret(T, d, E, k, C, skew, dtype):
    _, plan = _plan(T, d, E, k, C, T + 2 * C, skew)
    y = np.random.default_rng(C).standard_normal((E, C, d)).astype(np.float32)
    yt = _t(y).to(getattr(torch, dtype))
    got = md.combine(yt, plan)
    assert got.dtype == yt.dtype and got.shape == (T, d)
    cidx, w = plan.flat_combine_words()
    y_pad = jnp.concatenate([jnp.asarray(y, dtype).reshape(E * C, d), jnp.zeros((1, d), dtype)])
    want = np.asarray(combine_pallas(y_pad, jnp.asarray(cidx.numpy()), jnp.asarray(w.numpy()), top_k=k,
                                     interpret=True))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    else:  # the reference's ops.combine casts the f32 kernel output
        want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
        assert np.all(np.abs(got.float().numpy() - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


@pytest.mark.parametrize("E,M,K,N", [(3, 37, 100, 130), (2, 16, 64, 256), (4, 1, 7, 5), (1, 130, 33, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_plain_matches_pallas_interpret(E, M, K, N, dtype):
    rng = np.random.default_rng(M * N)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    got = gg.grouped_gemm(_t(x).to(getattr(torch, dtype)), _t(w).to(getattr(torch, dtype)))
    assert got.shape == (E, M, N) and got.dtype == getattr(torch, dtype)
    want = np.asarray(grouped_gemm_pallas(jnp.asarray(x, dtype), jnp.asarray(w, dtype), interpret=True)
                      .astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=1e-5)
    else:
        assert np.all(np.abs(got.float().numpy() - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)


def _expert_params(E, d, f, seed):
    rng = np.random.default_rng(seed)
    return {
        "w_gate": (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32),
        "w_up": (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32),
        "w_down": (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32),
    }


@pytest.mark.parametrize("E,C,d,f", [(4, 6, 32, 24), (8, 16, 64, 48)])
def test_fused_experts_fn_matches_local_experts_fn(E, C, d, f):
    """Kernel 3 over the identity index + kernel 8, and the grouped SwiGLU
    (kernel 8 three times, the reference's ``pallas_experts_fn``), against
    the reference's batched-einsum experts; zero rows (empty slots) stay
    zero."""
    p = _expert_params(E, d, f, C)
    slots = np.random.default_rng(E).standard_normal((E, C, d)).astype(np.float32)
    slots[:, -2:] = 0.0
    want = np.asarray(local_experts_fn(jnp.asarray(slots), {k: jnp.asarray(v) for k, v in p.items()}))
    tp = {k: _t(v) for k, v in p.items()}
    got = fused_experts_fn(_t(slots), tp)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.all(got[:, -2:].numpy() == 0.0)
    np.testing.assert_allclose(gg.experts_fn(_t(slots), tp).numpy(), want, atol=1e-5, rtol=1e-5)
    j_sw = j_grouped_swiglu(jnp.asarray(slots), *(jnp.asarray(p[k]) for k in ("w_gate", "w_up", "w_down")),
                            interpret=True)
    np.testing.assert_allclose(gg.grouped_swiglu(_t(slots), tp["w_gate"], tp["w_up"], tp["w_down"]).numpy(),
                               np.asarray(j_sw), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("E,ep", [(12, 3), (8, 2), (8, 4), (16, 1)])
def test_shard_slice_matches_reference(E, ep):
    rng = np.random.default_rng(E + ep)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    wr = (0.5 * rng.standard_normal((16, E))).astype(np.float32)
    jplan = j_route_decode(jnp.asarray(x), jnp.asarray(wr), 3)
    plan = DecodePlan(_t(np.asarray(jplan.expert_ids)), _t(np.asarray(jplan.weights)))
    for s in range(ep):
        got = plan.shard_slice(s * (E // ep), E // ep)
        want = jplan.shard_slice(s * (E // ep), E // ep)
        assert got.expert_ids.dtype == torch.int32 and got.weights.dtype == torch.float32
        np.testing.assert_array_equal(got.expert_ids.numpy(), np.asarray(want.expert_ids))
        np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))


def test_shard_slice_partitions_assignments():
    """The per-shard slices partition the assignments: local ids in bounds,
    masked assignments carry exactly zero weight, resident ones are
    untouched, and the slices' weights sum to the plan's exactly."""
    rng = np.random.default_rng(0)
    E, ep, T, k = 12, 3, 6, 3
    ids = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    plan = DecodePlan(_t(ids), _t(w))
    E_loc = E // ep
    total = np.zeros((T, k), np.float32)
    for s in range(ep):
        local = plan.shard_slice(s * E_loc, E_loc)
        lid, lw = local.expert_ids.numpy(), local.weights.numpy()
        assert lid.min() >= 0 and lid.max() < E_loc
        resident = (ids // E_loc) == s
        np.testing.assert_array_equal(lw != 0.0, resident & (w != 0.0))
        np.testing.assert_array_equal(lid[resident], ids[resident] - s * E_loc)
        total += lw
    np.testing.assert_array_equal(total, w)


def test_replace_combine_matches_reference_and_drops_flat_views():
    T, d, E, k, C = 12, 16, 4, 2, 4
    _, plan = _plan(T, d, E, k, C, 3, skew=True)
    assert plan.flat_cidx is not None and plan.slot_w is not None
    idx = plan.combine_idx.clone()
    idx[::2] = -1
    w = torch.where(idx >= 0, plan.combine_w, torch.zeros_like(plan.combine_w))
    got = plan.replace_combine(combine_idx=idx, combine_w=w)
    assert got.flat_cidx is None and got.flat_cw is None and got.slot_w is None
    assert got.flat_idx is plan.flat_idx  # the dispatch view stays valid
    jplan = JDispatchPlan(*(None if f is None else jnp.asarray(f.numpy()) for f in plan))
    want = jplan.replace_combine(combine_idx=jnp.asarray(idx.numpy()), combine_w=jnp.asarray(w.numpy()))
    for a, b in ((got.flat_combine_words(), want.flat_combine_words()), ((got.flat_slot_w(),), (want.flat_slot_w(),))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_cpu_wrappers_count_no_launch_and_reject_bad_operands():
    x, plan = _plan(8, 16, 4, 2, 4, 1)
    md.dispatch.launches = md.combine.launches = gg.grouped_gemm.launches = 0
    md.combine(md.dispatch(_t(x), plan), plan)
    gg.grouped_gemm(torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    assert md.dispatch.launches == md.combine.launches == gg.grouped_gemm.launches == 0
    with pytest.raises(ValueError, match="shapes"):
        gg.grouped_gemm(torch.ones(2, 3, 4), torch.ones(2, 5, 5))
    with pytest.raises(ValueError, match="float32"):
        gg.grouped_gemm(torch.ones(2, 3, 4), torch.ones(2, 4, 5, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="do not fit"):
        md.combine(torch.ones(3, 4, 16), plan)
