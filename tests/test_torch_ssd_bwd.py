"""PyTorch port, kernel 11's backward (11_bwd) on the CPU: the plain
version ``ssd_chunked_bwd`` against ``jax.vjp`` of the reference's
``ssd_chunked`` and against ``torch.autograd`` of the port's plain forward
(a zero state; h0 with dh_final; a ragged T, also past 256 steps; chunks
of 16 and 64; N 16 and 128; P 16 and 64), ``ssd_scan_train``'s gradients on the CPU (x, B and C as
views of one projection, routed through the split) equal to
``ssd_chunked_bwd``'s, the plain backward at the CUDA-core build's chunk
(64) equal to it at the tensor-core build's (256), the wrapper's refusals,
and the C entries' arguments and scratch through a fake ``function`` (no
card here).

Gate: f32, every gradient within 1e-4 of that gradient's largest
magnitude (sums in other orders).  Inputs come from a numpy seed with dt
in the range where the reference's VJP is finite: the reference selects
after the exponential (``jnp.where(causal, exp(cum_i - cum_j), 0)``), so
where ``cum_i - cum_j`` above the diagonal overflows its VJP multiplies 0
by inf and gives NaN (ROADMAP Queue C, R8); the port masks before the
exponential, and ``test_port_is_finite_where_the_reference_vjp_is_nan``
holds it against autograd there.
"""
from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as JM
from repro_torch import kernels
from repro_torch.kernels.ssd_scan import ops, ref

TOL = 1e-4
NAMES = ("dx", "ddt", "da", "dB", "dC", "dh0")
# B, T, H, P, N, chunk, h0 and dh_final given
CASES = {"zero_state": (2, 64, 3, 16, 16, 16, False), "h0_dh_final": (2, 48, 3, 16, 16, 16, True),
         "ragged": (2, 37, 2, 16, 16, 16, True), "chunk64_ragged": (1, 150, 2, 16, 16, 64, True),
         "n128": (1, 40, 2, 16, 128, 16, True), "p64": (1, 70, 2, 64, 16, 64, False),
         "mamba2_dims": (1, 70, 2, 64, 128, 64, True), "ragged_300": (1, 300, 2, 16, 16, 64, True)}


def _inputs(case, dt_max=None, seed=0):
    """numpy inputs; dt uniform in [1e-3, dt_max] with dt_max so that no
    chunk's decay sum passes 80 (the reference's exp stays finite above
    the diagonal), a = -linspace(1, 16, H) as the model initialises it."""
    B, T, H, P, N, chunk, with_state = CASES[case]
    rng = np.random.default_rng(seed + T)
    dt_max = dt_max or 80.0 / (16.0 * min(chunk, T))
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = rng.uniform(1e-3, dt_max, (B, T, H)).astype(np.float32)
    a = -np.linspace(1.0, 16.0, H).astype(np.float32)
    bm = (0.5 * rng.standard_normal((B, T, N))).astype(np.float32)
    cm = (0.5 * rng.standard_normal((B, T, N))).astype(np.float32)
    dy = rng.standard_normal((B, T, H, P)).astype(np.float32)
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32) if with_state else None
    dhf = rng.standard_normal((B, H, N, P)).astype(np.float32) if with_state else None
    return chunk, (x, dt, a, bm, cm), dy, dhf, h0


def _t(v):
    return None if v is None else torch.from_numpy(v)


def _hold(name, got, want):
    got, want = got.float(), torch.as_tensor(np.array(want)).float()
    assert got.shape == want.shape, name
    assert torch.isfinite(want).all(), f"{name}: the reference is not finite"
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()), (name, err)


def _jax_vjp(chunk, args, dy, dhf, h0):
    jargs = [jnp.asarray(v) for v in args]
    if h0 is None:
        (y, h), vjp = jax.vjp(lambda *a: JM.ssd_chunked(*a, chunk), *jargs)
        return vjp((jnp.asarray(dy), jnp.zeros_like(h))) + (None,)
    (y, h), vjp = jax.vjp(lambda *a: JM.ssd_chunked(*a[:5], chunk, h0=a[5]), *jargs, jnp.asarray(h0))
    return vjp((jnp.asarray(dy), jnp.asarray(dhf)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_reference_vjp(case):
    chunk, args, dy, dhf, h0 = _inputs(case)
    want = _jax_vjp(chunk, args, dy, dhf, h0)
    got = ref.ssd_chunked_bwd(*map(_t, args), chunk, _t(dy), _t(dhf), _t(h0))
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
        else:
            assert g.dtype == torch.float32
            _hold(name, g, w)


def _autograd(chunk, args, dy, dhf, h0):
    leaves = [_t(v).requires_grad_(True) for v in args] + ([] if h0 is None else [_t(h0).requires_grad_(True)])
    y, h = ref.ssd_chunked(*leaves[:5], chunk, leaves[5] if h0 is not None else None)
    outs, grads = [y], [_t(dy)]
    if dhf is not None:
        outs, grads = [y, h], [_t(dy), _t(dhf)]
    return torch.autograd.grad(outs, leaves, grads) + ((None,) if h0 is None else ())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    chunk, args, dy, dhf, h0 = _inputs(case)
    want = _autograd(chunk, args, dy, dhf, h0)
    got = ref.ssd_chunked_bwd(*map(_t, args), chunk, _t(dy), _t(dhf), _t(h0))
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
        else:
            _hold(name, g, w.detach())


def test_port_is_finite_where_the_reference_vjp_is_nan():
    """dt up to 1.7 at chunk 16: some cum_i - cum_j above the diagonal
    passes 88, and the reference's VJP gives NaN in ddt (0 x inf through
    its where); the port's closed form stays finite and equals autograd
    through its own forward, which masks before the exponential."""
    chunk, args, dy, dhf, h0 = _inputs("ragged", dt_max=1.7)
    want = _jax_vjp(chunk, args, dy, dhf, h0)
    assert np.isnan(np.asarray(want[1])).any() and not np.isnan(np.asarray(want[0])).any()
    got = ref.ssd_chunked_bwd(*map(_t, args), chunk, _t(dy), _t(dhf), _t(h0))
    assert all(torch.isfinite(g).all() for g in got)
    for name, g, w in zip(NAMES, got, _autograd(chunk, args, dy, dhf, h0)):
        _hold(name, g, w.detach())


@pytest.mark.parametrize("case", ["h0_dh_final", "zero_state", "mamba2_dims"])
def test_training_function_on_cpu_equals_the_plain_backward(case):
    """``ssd_scan_train`` with x, B and C as views of one projection: the
    gradients autograd routes through the split are ``ssd_chunked_bwd``'s,
    bitwise (the Function runs the plain versions on the CPU and counts no
    launch); a None gradient of the final state is zeros."""
    chunk, (x, dt, a, bm, cm), dy, dhf, h0 = _inputs(case)
    B, T, H, P = x.shape
    N = bm.shape[-1]
    proj = torch.from_numpy(np.concatenate([x.reshape(B, T, H * P), bm, cm], -1)).requires_grad_(True)
    tdt, ta = _t(dt).requires_grad_(True), _t(a).requires_grad_(True)
    th0 = None if h0 is None else _t(h0).requires_grad_(True)
    kernels.reset_launch_counts()
    y, h = ops.ssd_scan_train(proj[..., :H * P].reshape(B, T, H, P), tdt, ta, proj[..., H * P:H * P + N],
                              proj[..., H * P + N:], chunk, h0=th0)
    if dhf is None:
        y.backward(_t(dy))
    else:
        torch.autograd.backward([y, h], [_t(dy), _t(dhf)])
    assert not any(kernels.launch_counts().values())
    want = ref.ssd_chunked_bwd(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk, _t(dy), _t(dhf), _t(h0))
    assert torch.equal(proj.grad, torch.cat([want[0].reshape(B, T, H * P), want[3], want[4]], -1))
    assert torch.equal(tdt.grad, want[1]) and torch.equal(ta.grad, want[2])
    assert (th0 is None and want[5] is None) or torch.equal(th0.grad, want[5])


def test_no_graph_under_no_grad():
    chunk, args, _, _, _ = _inputs("zero_state")
    leaves = [_t(v).requires_grad_(True) for v in args]
    with torch.no_grad():
        y, h = ops.ssd_scan_train(*leaves, chunk)
    assert y.grad_fn is None and h.grad_fn is None
    assert torch.equal(y, ref.ssd_chunked(*map(_t, args), chunk)[0])


def test_wrapper_refusals():
    chunk, args, dy, _, _ = _inputs("zero_state")
    x, dt, a, bm, cm = map(_t, args)
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_scan_bwd(x, dt, a, bm, cm, chunk, _t(dy)[:, :-1])
    with pytest.raises(ValueError, match="unsupported device"):
        meta = [t.to("meta") for t in (x, dt, a, bm, cm)]
        ops.ssd_scan_bwd(*meta, chunk, _t(dy).to("meta"))


def test_backward_build_choice():
    """bf16 at Mamba-2's state size and head dim (every Mamba-2 layer) that
    TMA reads in place takes the tensor cores; f32 anywhere, bf16 at any
    other shape, and bf16 TMA cannot read in place, the CUDA cores; each
    build at its own chunk."""
    assert ops.ssd_scan_bwd_path(torch.bfloat16, 128, 64, True) == "tensor_cores"
    for dtype, N, P in ((torch.float32, 128, 64), (torch.bfloat16, 16, 16), (torch.bfloat16, 128, 32),
                        (torch.bfloat16, 64, 64)):
        assert ops.ssd_scan_bwd_path(dtype, N, P, True) == "cuda_cores"
    assert ops.ssd_scan_bwd_path(torch.bfloat16, 128, 64, False) == "cuda_cores"
    assert ops.BWD_CHUNK == {"cuda_cores": 64, "tensor_cores": ops.TC_CHUNK} and ops.TC_CHUNK == 256


@pytest.mark.parametrize("case", ["chunk64_ragged", "mamba2_dims", "p64", "ragged_300"])
def test_plain_backward_is_the_same_at_either_builds_chunk(case):
    """The two builds chunk the backward differently (64 and 256 steps):
    the plain version at each, the same function summed in another order,
    agree within the f32 gate (dt kept so that the decay over 256 steps
    stays finite, as the reference's VJP needs at its chunk)."""
    B, T, H, P, N, _, with_state = CASES[case]
    chunk, args, dy, dhf, h0 = _inputs(case, dt_max=80.0 / (16.0 * 256))
    at = {q: ref.ssd_chunked_bwd(*map(_t, args), q, _t(dy), _t(dhf), _t(h0))
          for q in (ops.BWD_CHUNK["cuda_cores"], ops.BWD_CHUNK["tensor_cores"])}
    for name, g, w in zip(NAMES, at[64], at[256]):
        if w is None:
            assert g is None, name
        else:
            _hold(name, g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "mamba2_dims"])
def test_c_entry_takes_its_arguments_and_scratch(case, dtype, monkeypatch):
    """The wrapper's launch: the tensor-core entry for bf16 at N 128, P 64
    and the CUDA-core one otherwise, x, B and C in place through their
    strides (views of one projection), outputs in x's type (ddt, da, dh0
    f32), the scratch :func:`ops.bwd_scratch_floats` long for the build
    (the CUDA cores' per chunk of 64, the tensor cores' regions per chunk of
    256, each rounded to 64 elements), dh_final / h0 / dh0 null together
    and 16-byte aligned otherwise, dy 16-byte aligned."""
    chunk, (x, dt, a, bm, cm), dy, dhf, h0 = _inputs(case)
    B, T, H, P = x.shape
    N = bm.shape[-1]
    calls = []

    def fake(name, symbol, argtypes):
        def launch(*args):
            calls.append((name, symbol, len(argtypes), args))
            return 0
        return launch

    allocated = []
    empty = torch.empty

    def recording_empty(*shape, **kw):  # the wrapper's allocations, the scratch last
        t = empty(*shape, **kw)
        allocated.append(t)
        return t

    monkeypatch.setattr(kernels, "function", fake)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty", recording_empty)
    proj = torch.from_numpy(np.concatenate([x.reshape(B, T, H * P), bm, cm], -1)).to(dtype)
    tx, tb, tc = proj[..., :H * P].reshape(B, T, H, P), proj[..., H * P:H * P + N], proj[..., H * P + N:]
    dx, ddt, da, dB, dC, dh0 = ops._launch_bwd(tx, _t(dt), _t(a), tb, tc, _t(dy), _t(dhf), _t(h0))
    assert dx.shape == (B, T, H, P) and dB.shape == dC.shape == (B, T, N)
    assert dx.dtype == dB.dtype == dC.dtype == dtype and ddt.dtype == da.dtype == torch.float32
    assert (dh0 is None) == (h0 is None)
    [(name, symbol, nargs, args)] = calls
    on_tc = dtype == torch.bfloat16 and (N, P) == (128, 64)
    assert ops.ssd_scan_bwd_path(dtype, N, P, ops.tma_ready(tx, tb, tc)) == ("tensor_cores" if on_tc else "cuda_cores")
    if on_tc:
        assert (name, symbol) == ("ssd_scan", "repro_ssd_scan_bwd_tc") and nargs == len(args) == 27
        args = (None,) + args  # the CUDA-core entry's dtype code goes first
    else:
        assert (name, symbol) == ("ssd_scan", "repro_ssd_scan_bwd") and nargs == len(args) == 28
        assert args[0] == int(dtype == torch.bfloat16)
    assert args[-6:] == (B, T, H, N, P, 0)
    stride = H * P + 2 * N
    assert args[1].value == tx.data_ptr() and args[2:4] == (T * stride, stride)
    assert args[6].value == tb.data_ptr() and args[7:9] == (T * stride, stride)
    assert args[9].value == tc.data_ptr() and args[10:12] == (T * stride, stride)
    for i in (13, 14, 20):  # dh_final, h0, dh0
        assert isinstance(args[i], ctypes.c_void_p) and (args[i].value is None) == (h0 is None)
        assert args[i].value is None or args[i].value % 16 == 0
    assert args[12].value % 16 == 0  # dy
    scratch = allocated[-1]
    assert args[21].value == scratch.data_ptr() and scratch.dtype == torch.float32
    path = "tensor_cores" if on_tc else "cuda_cores"
    assert scratch.numel() == ops.bwd_scratch_floats(B, T, H, N, P, path)
    if on_tc:
        nc = -(-T // 256)
        u, r64 = B * nc * H, lambda n: -(-n // 64) * 64
        regions = (u * N * P, 2 * u * 256, u, u * N * P, 2 * u * 256, u * N * P, u * N * P, u * 8, B * T * H * P,
                   u * 256, 2 * u * 256, u * 256, 4 * u * 256, B * nc * -(-H // 8) * 10 * 4096,
                   B * nc * 10 * 4096, B * T * -(-H // 8) * N, B * T * -(-H // 8) * N, B * nc * H)
        assert scratch.numel() == sum(map(r64, regions))
    else:
        assert scratch.numel() == B * -(-T // 64) * H * (2 * N * P + 2) + 2 * B * T * H * N
