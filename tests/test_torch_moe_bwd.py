"""PyTorch port, the training backward kernels 3_bwd, 4_bwd (the fused MoE
pair's, ``csrc/moe_fused_bwd.cu``) and 12_bwd (the RG-LRU scan's reversed
instantiation, ``csrc/rglru_scan.cu``): each plain version against autograd
through its plain forward at ragged shapes (empty slots, assignments over
capacity dropped, T not a multiple of the scan's chunk, h0, bf16 gates),
the autograd Functions on the CPU (plain versions both ways, no launch
counted), and each C entry's arguments and scratch through a fake
``function`` (no card here).  CPU only.

Gates: f32 gradients within 1e-5 of autograd's (relative to the largest
magnitude, at least 1), bf16 ones within 2^-7 of it plus 1e-3.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.control_plane import capacity_for, route_topk
from repro_torch.kernels.moe_fused import ops as mf_ops
from repro_torch.kernels.moe_fused import ref as mf_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import ref as rg_ref


def _close(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(1.0, float(want.float().abs().max())), err


# T, d, f, E, k, capacity factor (< 1 drops assignments; every case leaves some slot empty)
MOE_CASES = {"ragged_drops": (37, 24, 40, 12, 2, 0.3), "top1_sparse": (13, 16, 24, 8, 1, 1.25),
             "wide_k": (29, 8, 72, 5, 4, 1.0)}


def _moe_inputs(case, dtype=torch.float32):
    T, d, f, E, k, cf = MOE_CASES[case]
    rng = np.random.default_rng(T)
    t = lambda *shape, s=1.0: torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(dtype)
    x, router = t(T, d), t(d, E).float()
    plan, _ = route_topk(x.float(), router, k, capacity_for(T, E, k, cf))
    wg, wu, wd = t(E, d, f, s=d ** -0.5), t(E, d, f, s=d ** -0.5), t(E, f, d, s=f ** -0.5)
    return x, plan, wg, wu, wd


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_plain_backwards_match_autograd_through_the_plain_forwards(case):
    x, plan, wg, wu, wd = _moe_inputs(case)
    T, k = plan.combine_idx.shape
    idx, cidx = plan.flat_idx, plan.flat_cidx
    occupied = int((idx < T).sum())
    assert occupied < idx.numel(), "the case must leave some slot empty"
    if case == "ragged_drops":
        assert int((cidx == idx.numel()).sum()) > 0, "the case must drop an assignment"
    rng = np.random.default_rng(7)
    sw = plan.slot_w.clone().requires_grad_(True)
    xs, wgs, wus, wds = (v.clone().requires_grad_(True) for v in (x, wg, wu, wd))
    h = mf_ref.gather_swiglu(xs, idx, wgs, wus)
    y = mf_ref.down_combine(h, wds, idx, sw, T)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    dh_want, = torch.autograd.grad(y, h, dy, retain_graph=True)
    want = torch.autograd.grad(y, (xs, sw, wgs, wus, wds), dy)
    dh, dwd, dsw = mf_ref.down_combine_bwd(dy, h.detach(), wd, idx, plan.slot_w)
    dx, dwg, dwu = mf_ref.gather_swiglu_bwd(dh, x, idx, cidx, wg, wu)
    _close(dh, dh_want, 1e-5)
    for got, w in zip((dx, dsw, dwg, dwu, dwd), want):
        _close(got, w, 1e-5)
    # empty slots: no gradient into dh or slot_w
    empty = idx >= T
    assert not dh.reshape(-1, dh.shape[-1])[empty].any() and not dsw[empty].any()


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_plain_backwards_in_bf16_round_once(case):
    """bf16 operands: the plain backward computes in f32 and rounds each
    output once, so it holds to one bf16 ulp of the f32 backward on the
    same (bf16-valued) operands."""
    x, plan, wg, wu, wd = _moe_inputs(case, torch.bfloat16)
    T = x.shape[0]
    h = mf_ref.gather_swiglu(x, plan.flat_idx, wg, wu)
    dy = torch.from_numpy(np.random.default_rng(3).standard_normal((T, x.shape[1])).astype(np.float32))
    got = mf_ref.down_combine_bwd(dy, h, wd, plan.flat_idx, plan.slot_w)
    want = mf_ref.down_combine_bwd(dy, h.float(), wd.float(), plan.flat_idx, plan.slot_w)
    for g, w in zip(got, want):
        assert g.dtype == (torch.float32 if g.ndim == 1 else torch.bfloat16)
        err = (g.float() - w).abs()
        assert bool((err <= 2.0 ** -7 * w.abs() + 1e-3).all())


def test_moe_autograd_function_takes_the_plain_versions_on_the_cpu():
    x, plan, wg, wu, wd = _moe_inputs("ragged_drops")
    p = {"w_gate": wg, "w_up": wu, "w_down": wd}
    leaves = (x, plan.slot_w, wg, wu, wd)
    for t in leaves:
        t.requires_grad_(True)
    kernels.reset_launch_counts()
    y = mf_ops.fused_moe_fn(x, plan._replace(slot_w=plan.slot_w), p)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, mf_ref.down_combine(mf_ref.gather_swiglu(x, plan.flat_idx, wg, wu), wd,
                                                      plan.flat_idx, plan.slot_w, x.shape[0]).detach(),
                               rtol=0, atol=0)
    dy = torch.ones_like(y)
    got = torch.autograd.grad(y, leaves, dy)
    h = mf_ref.gather_swiglu(x, plan.flat_idx, wg, wu)
    want = torch.autograd.grad(mf_ref.down_combine(h, wd, plan.flat_idx, plan.slot_w, x.shape[0]), leaves, dy)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    assert not any(kernels.launch_counts().values())


def _fake_function(monkeypatch):
    calls = []

    def fake(name, symbol, argtypes):
        def launch(*args):
            calls.append((name, symbol, len(argtypes), args))
            return 0
        return launch

    monkeypatch.setattr(kernels, "function", fake)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)  # no CUDA stream on the CPU
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_backward_c_entries_take_their_arguments_and_scratch(dtype, monkeypatch):
    x, plan, wg, wu, wd = _moe_inputs("ragged_drops", dtype)
    T, d = x.shape
    E, _, f = wg.shape
    C = plan.flat_idx.numel() // E
    calls = _fake_function(monkeypatch)
    # the CUDA-core entries (bf16 at this shape would take the tensor-core
    # ones, held in tests/test_torch_moe_bwd_tc.py)
    monkeypatch.setattr(mf_ops, "down_combine_bwd_path", lambda *a: "cuda_cores")
    monkeypatch.setattr(mf_ops, "gather_swiglu_bwd_path", lambda *a: "cuda_cores")
    dh = torch.zeros((E, C, f), dtype=dtype)
    out = mf_ops._launch_down_combine_bwd(torch.zeros((T, d)), dh, wd, plan.flat_idx, plan.slot_w)
    assert [t.shape for t in out] == [(E, C, f), (E, f, d), (E * C,)]
    assert [t.dtype for t in out] == [dtype, dtype, torch.float32]
    out = mf_ops._launch_gather_swiglu_bwd(dh, x, plan.flat_idx, plan.flat_cidx, wg, wu)
    assert [t.shape for t in out] == [(T, d), (E, d, f), (E, d, f)] and {t.dtype for t in out} == {dtype}
    (n1, s1, a1, args1), (n2, s2, a2, args2) = calls
    assert (n1, s1, n2, s2) == ("moe_fused_bwd", "repro_down_combine_bwd", "moe_fused_bwd", "repro_gather_swiglu_bwd")
    assert a1 == len(args1) == 16 and a2 == len(args2) == 19
    code = int(dtype == torch.bfloat16)
    assert args1[0] == args2[0] == code
    assert args1[-6:] == (T, E, C, d, f, 0)
    assert args2[-7:] == (T, E, C, d, f, plan.combine_idx.shape[1], 0)


# B, T, W, h0, gate dtype
SCAN_CASES = {"ragged_h0": (2, 133, 12, True, torch.float32), "short": (1, 5, 8, False, torch.float32),
              "chunks_bf16": (2, 260, 4, True, torch.bfloat16), "one_step": (3, 1, 6, True, torch.float32)}


def _scan_inputs(case):
    B, T, W, with_h0, dtype = SCAN_CASES[case]
    rng = np.random.default_rng(T + W)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (B, T, W)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal((B, T, W)).astype(np.float32) * 0.1).to(dtype)
    h0 = torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32)) if with_h0 else None
    g = torch.from_numpy(rng.standard_normal((B, T, W)).astype(np.float32))
    return a, b, h0, g


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_plain_backward_matches_autograd_through_the_plain_scan(case):
    a, b, h0, g = _scan_inputs(case)
    leaves = [a.float().requires_grad_(True), b.float().requires_grad_(True)]
    if h0 is not None:
        leaves.append(h0.clone().requires_grad_(True))
    h = rg_ref.linear_scan(*leaves)
    want = torch.autograd.grad(h, leaves, g)
    da, db, dh0 = rg_ref.rglru_scan_bwd(a, h.detach(), g, h0)
    assert da.dtype == db.dtype == a.dtype and (dh0 is None) == (h0 is None)
    tol = 1e-5 if a.dtype == torch.float32 else 2.0 ** -7
    for got, w in zip((da, db) + ((dh0,) if h0 is not None else ()), want):
        _close(got.float(), w, tol)


def test_scan_autograd_function_takes_the_plain_versions_on_the_cpu():
    a, b, h0, g = _scan_inputs("ragged_h0")
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    kernels.reset_launch_counts()
    h = rg_ops.rglru_scan_train(*leaves)
    assert torch.equal(h, rg_ref.linear_scan(a, b, h0))
    got = torch.autograd.grad(h, leaves, g)
    want = rg_ref.rglru_scan_bwd(a, h.detach(), g, h0)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_backward_c_entry_takes_its_arguments_and_scratch(case, monkeypatch):
    a, b, h0, g = _scan_inputs(case)
    B, T, W = a.shape
    calls = _fake_function(monkeypatch)
    h = torch.zeros((B, T, W))
    da, db, dh0 = rg_ops._launch_bwd(a, h, g, h0)
    assert da.shape == db.shape == a.shape and da.dtype == db.dtype == a.dtype
    assert (dh0 is None) == (h0 is None)
    [(name, symbol, nargs, args)] = calls
    assert (name, symbol) == ("rglru_scan", "repro_rglru_scan_bwd") and nargs == len(args) == 14
    vec = args[-2]
    assert vec == (rg_ops.LANE_CHANNELS if W % rg_ops.LANE_CHANNELS == 0 else 1)
    assert args[0] == int(a.dtype == torch.bfloat16) and args[-5:] == (B, T, W, vec, 0)
    assert (args[4] is None) == (h0 is None) and (args[7] is None) == (h0 is None)
