"""PyTorch port, on the card: the training backward kernels 3_bwd, 4_bwd
(``csrc/moe_fused_bwd.cu``), 12_bwd (the reversed instantiation in
``csrc/rglru_scan.cu``) and 11_bwd (``repro_ssd_scan_bwd`` in
``csrc/ssd_scan.cu``) against their plain versions, at ragged shapes
(empty slots, dropped assignments, T off the scan's chunk, W off its
4-channel lanes, h0; for 11_bwd also dh_final, N and P off 128 and 64, and
bf16 x, B and C as strided views of one projection), f32 and bf16, each
bitwise on a repeat (11_bwd's tensor-core build also at T off its chunk of
256 with h0 and dh_final, under one row tile, and at head counts off its
head groups); and the autograd Functions on the card counting one launch
each way.  3_bwd and
4_bwd take their tensor-core builds for bf16 with d and f multiples of 8
(each case asserts the build it takes): C off the 64-slot units, an expert
with no occupied slot, several 256-column tiles with a ragged last one;
bf16 at d 20 keeps the CUDA-core build.  The a2a body's backwards: 8_bwd
(``csrc/grouped_gemm.cu``; bf16 with K and N multiples of 8 on the tensor
cores, M off the 64-row tile, one row, ragged K and N tiles, the a2a
training shape over 2 experts, dw's dy resident and streamed, dx's second
half of 160 slots past M and ragged, the entry's refusal of a resident dy
past its budget, f32 and bf16
at K 20 on CUDA cores), 10_bwd and kernel 9's backward (kernel 10 with unit
weights) at k 1 and 8 with dropped assignments and empty slots, kernel 3's
identity-index backward, and the autograd Functions of the a2a body
counting one launch each way.

Runs only where ``torch.cuda.is_available()``; elsewhere every test skips
(a CUDA kernel has no CPU mode).  Imports no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_bwd.py
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.control_plane import capacity_for, make_dispatch_plan, route_topk
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.kernels.grouped_gemm import ref as gg_ref
from repro_torch.kernels.moe_dispatch import ops as md_ops
from repro_torch.kernels.moe_dispatch import ref as md_ref
from repro_torch.kernels.moe_fused import ops as mf_ops
from repro_torch.kernels.moe_fused import ref as mf_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import ref as rg_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _hold(name, got, want):
    """f32 outputs: 1e-4 of the output scale (sums in another order); bf16
    outputs elementwise: one bf16 ulp (2^-7 of the value) plus 1e-3 x rms."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        err = float((g - w).abs().max())
        assert err <= 1e-4 * max(1.0, float(w.abs().max())), (name, err)
    else:
        lim = 2.0 ** -7 * w.abs() + 1e-3 * float(w.pow(2).mean().sqrt())
        assert int(((g - w).abs() > lim).sum()) == 0, name


# T, d, f, E, k, capacity factor; "idle" cases never route to expert 0
MOE_CASES = {"ragged_drops": (37, 24, 40, 12, 2, 0.3), "top1": (13, 16, 24, 8, 1, 1.25),
             "wide": (300, 72, 136, 6, 3, 1.0), "aligned": (256, 128, 192, 16, 4, 1.25),
             "tiles_idle": (600, 520, 328, 6, 2, 1.0), "ragged_idle": (1000, 264, 200, 24, 4, 1.0),
             "d20": (50, 20, 36, 6, 2, 1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_backward_kernels_match_plain_on_card(cuda, case, dtype):
    T, d, f, E, k, cf = MOE_CASES[case]
    rng = np.random.default_rng(T)
    t = lambda *shape, s=1.0: torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(cuda)
    x, router = t(T, d), t(d, E)
    C = capacity_for(T, E, k, cf)
    if case.endswith("idle"):  # the router's top k with expert 0 left out: it gets no token
        probs = torch.softmax(x @ router, dim=-1)
        top_w, top_e = torch.topk(probs[:, 1:], k, dim=-1)
        plan = make_dispatch_plan(top_e + 1, top_w / top_w.sum(-1, keepdim=True), E, C)
    else:
        plan, _ = route_topk(x, router, k, C)
    x = x.to(dtype)
    wg, wu, wd = (w.to(dtype) for w in (t(E, d, f, s=d ** -0.5), t(E, d, f, s=d ** -0.5), t(E, f, d, s=f ** -0.5)))
    idx, sw, cidx = plan.flat_idx, plan.slot_w, plan.flat_cidx
    if case.endswith("idle"):
        assert not bool((idx[:C] < T).any()) and C % mf_ops.BWD_UNIT != 0
        assert bool((cidx == idx.numel()).any()), "the case must drop an assignment"
    h = mf_ops.gather_swiglu(x, idx, wg, wu)
    dy = t(T, d)
    want = "tensor_cores" if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0 else "cuda_cores"
    assert mf_ops.down_combine_bwd_path(dtype, f, d, True) == mf_ops.gather_swiglu_bwd_path(dtype, d, f, True) == want
    entries = []
    function = kernels.function

    def recording(name, symbol, argtypes):  # the C entries the wrappers launch
        entries.append(symbol)
        return function(name, symbol, argtypes)

    def down():
        return mf_ops.down_combine_bwd(dy, h, wd, idx, sw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "function", recording)
        got = down()
    for name, g, w in zip(("dh", "dw_down", "dslot_w"), got, mf_ref.down_combine_bwd(dy, h, wd, idx, sw)):
        _hold(f"4_bwd {name}", g, w)
    dh = got[0]

    def gather():
        return mf_ops.gather_swiglu_bwd(dh, x, idx, cidx, wg, wu)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "function", recording)
        got = gather()
    for name, g, w in zip(("dx", "dw_gate", "dw_up"), got, mf_ref.gather_swiglu_bwd(dh, x, idx, cidx, wg, wu)):
        _hold(f"3_bwd {name}", g, w)
    tail = "_tc" if want == "tensor_cores" else ""
    assert entries == [f"repro_down_combine_bwd{tail}", f"repro_gather_swiglu_bwd{tail}"]
    for fn in (down, gather):
        a, b = fn(), fn()
        assert all(torch.equal(p, q) for p, q in zip(a, b)), "a repeated launch is not bitwise equal"


# B, T, W, h0, gate dtype
SCAN_CASES = {"ragged_h0": (2, 133, 12, True, torch.float32), "scalar_lanes": (1, 300, 10, True, torch.float32),
              "bf16_chunks": (2, 260, 64, True, torch.bfloat16), "no_h0": (1, 4096, 256, False, torch.float32),
              "one_step": (3, 1, 8, True, torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_backward_kernel_matches_plain_on_card(cuda, case):
    B, T, W, with_h0, dtype = SCAN_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(T)
    a = (torch.rand((B, T, W), generator=gen, device=cuda) * 0.499 + 0.5).to(dtype)
    b = (torch.randn((B, T, W), generator=gen, device=cuda) * 0.1).to(dtype)
    h0 = torch.randn((B, W), generator=gen, device=cuda) if with_h0 else None
    g = torch.randn((B, T, W), generator=gen, device=cuda)
    h = rg_ops.rglru_scan(a, b, h0)

    def kernel():
        return rg_ops.rglru_scan_bwd(a, h, g, h0)

    got, want = kernel(), rg_ref.rglru_scan_bwd(a, h, g, h0)
    for name, x, y in zip(("da", "db", "dh0"), got, want):
        if y is None:
            assert x is None
        else:
            _hold(f"12_bwd {name}", x, y)
    again = kernel()
    assert all(x is None or torch.equal(x, y) for x, y in zip(got, again)), "a repeated launch is not bitwise equal"


@pytest.mark.cuda
def test_training_functions_launch_each_backward_once_on_card(cuda):
    T, d, f, E, k = 64, 32, 48, 8, 2
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((T, d), generator=gen, device=cuda, requires_grad=True)
    router = torch.randn((d, E), generator=gen, device=cuda, requires_grad=True)
    p = {n: (torch.randn(s, generator=gen, device=cuda) * 0.2).requires_grad_(True)
         for n, s in (("w_gate", (E, d, f)), ("w_up", (E, d, f)), ("w_down", (E, f, d)))}
    a = (torch.rand((2, 150, 16), generator=gen, device=cuda) * 0.5 + 0.5).requires_grad_(True)
    b = torch.randn((2, 150, 16), generator=gen, device=cuda, requires_grad=True)
    kernels.reset_launch_counts()
    plan, _ = route_topk(x, router, k, capacity_for(T, E, k, 1.0))
    loss = mf_ops.fused_moe_fn(x, plan, p).square().sum() + rg_ops.rglru_scan_train(a, b).sum()
    loss.backward()
    counts = {n: c for n, c in kernels.launch_counts().items() if c}
    assert counts == {"gather_swiglu": 1, "down_combine": 1, "gather_swiglu_bwd": 1, "down_combine_bwd": 1,
                      "rglru_scan": 1, "rglru_scan_bwd": 1}
    assert float(router.grad.abs().max()) > 0 and all(t.grad is not None for t in (x, a, b, *p.values()))


# B, T, H, P, N, dtype of x / B / C, h0 and dh_final, chunk
SSD_CASES = {"ragged_h0": (2, 133, 3, 16, 16, torch.float32, True, 16),
             "small_dims": (2, 70, 5, 8, 12, torch.float32, True, 64),
             "small_dims_bf16": (2, 70, 5, 8, 12, torch.bfloat16, True, 64),
             "mamba2_f32": (1, 1000, 8, 64, 128, torch.float32, True, 256),
             "mamba2_views_bf16": (2, 300, 4, 64, 128, torch.bfloat16, False, 256),
             "mamba2_ragged_h0_bf16": (1, 1000, 6, 64, 128, torch.bfloat16, True, 256),
             "one_step": (1, 1, 2, 4, 4, torch.bfloat16, True, 256),
             "one_step_tc": (1, 1, 2, 64, 128, torch.bfloat16, True, 256),
             "tc_ragged_odd_heads": (1, 700, 3, 64, 128, torch.bfloat16, True, 256),
             "tc_under_a_row_tile": (2, 40, 4, 64, 128, torch.bfloat16, True, 256),
             "tc_heads_past_a_group": (2, 520, 10, 64, 128, torch.bfloat16, True, 256)}


def _ssd_inputs(cuda, B, T, H, P, N, dtype, with_state):
    """x, B and C as views of one (B, T, H P + 2 N) projection, as the
    model passes them; dt and a in the model's ranges; dy f32."""
    gen = torch.Generator(device=cuda).manual_seed(T * H + N)
    proj = (torch.randn((B, T, H * P + 2 * N), generator=gen, device=cuda) * 0.5).to(dtype)
    x = proj[..., :H * P].reshape(B, T, H, P)
    bm, cm = proj[..., H * P:H * P + N], proj[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=gen, device=cuda) - 1.0)
    a = -torch.linspace(1.0, 16.0, H, device=cuda)
    dy = torch.randn((B, T, H, P), generator=gen, device=cuda)
    h0 = torch.randn((B, H, N, P), generator=gen, device=cuda) if with_state else None
    dhf = torch.randn((B, H, N, P), generator=gen, device=cuda) if with_state else None
    return x, dt, a, bm, cm, dy, dhf, h0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_backward_kernel_matches_plain_on_card(cuda, case, monkeypatch):
    """Each case on the build ``ssd_scan_bwd_path`` names: bf16 at N 128,
    P 64 on the tensor cores (chunks of 256 in row tiles of 64; T off the
    chunk with h0 and dh_final, T under one row tile, H off the column
    blocks' pairs and the row blocks' groups of 8), the rest on CUDA cores
    (the C entry asserted)."""
    B, T, H, P, N, dtype, with_state, chunk = SSD_CASES[case]
    x, dt, a, bm, cm, dy, dhf, h0 = _ssd_inputs(cuda, B, T, H, P, N, dtype, with_state)
    entries, function = [], kernels.function

    def spy(name, symbol, argtypes):
        entries.append(symbol)
        return function(name, symbol, argtypes)

    monkeypatch.setattr(kernels, "function", spy)

    def kernel():
        return ssd_ops.ssd_scan_bwd(x, dt, a, bm, cm, chunk, dy, dhf, h0)

    got, want = kernel(), ssd_ref.ssd_chunked_bwd(x, dt, a, bm, cm, chunk, dy, dhf, h0)
    tc = dtype == torch.bfloat16 and (N, P) == (128, 64)
    assert entries[0] == ("repro_ssd_scan_bwd_tc" if tc else "repro_ssd_scan_bwd")
    for name, g, w in zip(("dx", "ddt", "da", "dB", "dC", "dh0"), got, want):
        if w is None:
            assert g is None
        else:
            _hold(f"11_bwd {name}", g, w)
    again = kernel()
    assert all(g is None or torch.equal(g, h) for g, h in zip(got, again)), "a repeated launch is not bitwise equal"


@pytest.mark.cuda
def test_ssd_training_function_launches_each_way_once_on_card(cuda):
    """Gradients through views of one projection, routed by autograd
    through the split, equal the plain backward's; one launch each way."""
    B, T, H, P, N = 2, 150, 3, 16, 16
    x, dt, a, bm, cm, dy, dhf, h0 = _ssd_inputs(cuda, B, T, H, P, N, torch.float32, True)
    proj = torch.cat([x.reshape(B, T, H * P), bm, cm], dim=-1).requires_grad_(True)
    dt, a, h0 = dt.requires_grad_(True), a.requires_grad_(True), h0.requires_grad_(True)
    kernels.reset_launch_counts()
    y, h = ssd_ops.ssd_scan_train(proj[..., :H * P].reshape(B, T, H, P), dt, a, proj[..., H * P:H * P + N],
                                  proj[..., H * P + N:], 32, h0=h0)
    torch.autograd.backward([y, h], [dy, dhf])
    assert {n: c for n, c in kernels.launch_counts().items() if c} == {"ssd_scan": 1, "ssd_scan_bwd": 1}
    want = ssd_ref.ssd_chunked_bwd(x, dt.detach(), a.detach(), bm, cm, 32, dy, dhf, h0.detach())
    _hold("proj.grad", proj.grad, torch.cat([want[0].reshape(B, T, H * P), want[3], want[4]], dim=-1))
    for name, g, w in (("dt", dt.grad, want[1]), ("a", a.grad, want[2]), ("h0", h0.grad, want[5])):
        _hold(name, g, w)


# E, M, K, N of y[e] = x[e] @ w[e]; the tensor-core build's edges: tc_a2a
# the a2a training shape over 2 experts (dy resident, dx's two halves of
# 160 slots full); tc_m129 / tc_one_row dx's second half past M;
# tc_ragged_halves the second half ragged; tc_streamed M past the resident
# budget (dy streamed, dx over two 320-slot units), K and N off their tiles
GG_BWD_CASES = {"tc_aligned": (4, 320, 128, 256), "tc_ragged": (5, 70, 136, 264), "tc_one_row": (2, 1, 64, 72),
                "tc_wide": (3, 200, 520, 1032), "k20": (3, 37, 20, 40), "odd": (2, 17, 24, 36),
                "tc_a2a": (2, 320, 1536, 4096), "tc_m129": (3, 129, 136, 264), "tc_streamed": (2, 330, 200, 520),
                "tc_ragged_halves": (3, 200, 264, 272)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(GG_BWD_CASES))
def test_grouped_gemm_backward_matches_plain_on_card(cuda, case, dtype):
    E, M, K, N = GG_BWD_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(M + K)
    x, w, dy = (torch.randn(s, generator=gen, device=cuda).to(dtype) for s in ((E, M, K), (E, K, N), (E, M, N)))
    path = gg_ops.grouped_gemm_bwd_path(dtype, K, N, True)
    assert path == ("tensor_cores" if dtype == torch.bfloat16 and case.startswith("tc") else "cuda_cores")
    got = gg_ops.grouped_gemm_bwd(x, w, dy)
    torch.cuda.synchronize()
    for name, g, want in zip(("dx", "dw"), got, gg_ref.grouped_gemm_bwd(x, w, dy)):
        _hold(f"{case} {name}", g, want)
    again = gg_ops.grouped_gemm_bwd(x, w, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "a repeated launch is not bitwise equal"


@pytest.mark.cuda
def test_grouped_gemm_bwd_entry_refuses_a_resident_dy_past_its_budget(cuda):
    E, M, K, N = 2, 330, 64, 256
    assert gg_ops.grouped_gemm_bwd_schedule(M) == "dy_streamed"
    x, w, dy = (torch.zeros(s, dtype=torch.bfloat16, device=cuda) for s in ((E, M, K), (E, K, N), (E, M, N)))
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    fn = kernels.function("grouped_gemm", "repro_grouped_gemm_bwd_tc", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p])
    args = [kernels.ptr(t) for t in (x, w, dy, dx, dw)] + [E, M, K, N]
    assert fn(*args, 1, kernels.stream_of(x)) != 0, "a resident dy slice past the budget was not refused"
    assert fn(*args, 0, kernels.stream_of(x)) == 0
    torch.cuda.synchronize()


# T, d, E, k, capacity factor
COMBINE_BWD_CASES = {"k1": (13, 16, 8, 1, 1.25), "k8_drops": (200, 72, 16, 8, 0.5), "d20": (50, 20, 6, 2, 1.0),
                     "k8_wide": (96, 1024, 32, 8, 1.25)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(COMBINE_BWD_CASES))
def test_combine_and_dispatch_backwards_match_plain_on_card(cuda, case, dtype):
    T, d, E, k, cf = COMBINE_BWD_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(T)
    x = torch.randn((T, d), generator=gen, device=cuda)
    plan, _ = route_topk(x, torch.randn((d, E), generator=gen, device=cuda), k, capacity_for(T, E, k, cf))
    C = plan.capacity
    cidx, w = plan.flat_combine_words()
    idx = plan.flat_dispatch_idx()
    if cf < 1:
        assert int((cidx >= E * C).sum()) > 0, "the plan must drop assignments"
    else:
        assert int((idx >= T).sum()) > 0, "the plan must leave empty slots"
    y = torch.randn((E, C, d), generator=gen, device=cuda).to(dtype)
    dy = torch.randn((T, d), generator=gen, device=cuda).to(dtype)
    dslots, dw = md_ops.combine_bwd(dy, y, cidx, w, idx)
    dx = md_ops.dispatch_bwd(y, cidx, T)
    torch.cuda.synchronize()
    want_s, want_w = md_ref.combine_bwd(dy.cpu(), y.reshape(E * C, d).cpu(), cidx.cpu(), w.cpu(), idx.cpu())
    assert torch.equal(dslots.reshape(E * C, d).cpu(), want_s), "dslots: one f32 product rounded once, bitwise"
    _hold(f"{case} dw", dw.cpu(), want_w)
    _hold(f"{case} dx", dx.cpu(), md_ref.dispatch_bwd(y.reshape(E * C, d).cpu(), cidx.cpu(), T))
    again = md_ops.combine_bwd(dy, y, cidx, w, idx)
    assert torch.equal(again[0], dslots) and torch.equal(again[1], dw), "a repeated launch is not bitwise equal"
    assert torch.equal(md_ops.dispatch_bwd(y, cidx, T), dx)


@pytest.mark.cuda
def test_identity_index_gather_swiglu_backward_matches_plain_on_card(cuda):
    """3_bwd as the a2a body's experts run it: the identity as its slot and
    its combine words (k 1, T = E*C), bf16 on the tensor cores."""
    E, C, d, f = 6, 72, 136, 200
    gen = torch.Generator(device=cuda).manual_seed(3)
    t = lambda *s: (torch.randn(s, generator=gen, device=cuda) * 0.3).to(torch.bfloat16)  # noqa: E731
    x, dh, wg, wu = t(E * C, d), t(E, C, f), t(E, d, f), t(E, d, f)
    ident = torch.arange(E * C, dtype=torch.int32, device=cuda)
    assert mf_ops.gather_swiglu_bwd_path(torch.bfloat16, d, f, True) == "tensor_cores"
    got = mf_ops.gather_swiglu_bwd(dh, x, ident, ident, wg, wu)
    torch.cuda.synchronize()
    want = mf_ref.gather_swiglu_bwd(dh.cpu(), x.cpu(), ident.cpu(), ident.cpu(), wg.cpu(), wu.cpu())
    for name, g, w in zip(("dx", "dwg", "dwu"), got, want):
        _hold(name, g.cpu(), w)


@pytest.mark.cuda
def test_a2a_training_functions_launch_each_backward_once_on_card(cuda):
    """dispatch_fn -> fused_experts_fn -> combine_fn (the a2a body at ep 1)
    under autograd: kernels 9, 3, 8 and 10 once forward, 10 (as 9's
    backward), 8_bwd, 3_bwd and 10_bwd once backward; the router moves."""
    T, d, f, E, k = 64, 32, 48, 8, 2
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((T, d), generator=gen, device=cuda, requires_grad=True)
    router = torch.randn((d, E), generator=gen, device=cuda, requires_grad=True)
    p = {n: (torch.randn(s, generator=gen, device=cuda) * 0.2).requires_grad_(True)
         for n, s in (("w_gate", (E, d, f)), ("w_up", (E, d, f)), ("w_down", (E, f, d)))}
    kernels.reset_launch_counts()
    plan, _ = route_topk(x, router, k, capacity_for(T, E, k, 1.0))
    y = md_ops.combine_fn(mf_ops.fused_experts_fn(md_ops.dispatch_fn(x, plan), p), plan)
    y.square().sum().backward()
    counts = {n: c for n, c in kernels.launch_counts().items() if c}
    assert counts == {"moe_dispatch": 1, "gather_swiglu": 1, "grouped_gemm": 1, "moe_combine": 1,
                      "moe_dispatch_bwd": 1, "grouped_gemm_bwd": 1, "gather_swiglu_bwd": 1, "moe_combine_bwd": 1}
    assert float(router.grad.abs().max()) > 0 and all(t.grad is not None for t in (x, *p.values()))
