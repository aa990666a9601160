"""PyTorch port, kernel 7's backward on the CPU: which build
(``flash_attention_bwd_path``) a launch takes at every dtype and head dim,
the build each registered arch that trains takes in bf16 (the tensor
cores, RecurrentGemma-2B's hd 256 included), the wrapper's refusals before
anything is built or launched (on the card nothing falls back to another
build or to the plain version), the C entry each build's launch names,
the plain backward against ``jax.vjp`` of the reference's
``blockwise_attention`` at the tensor-core build's head dims and groups,
and the tensor-core build's precision design emulated in torch: P
and dS as hi + lo bf16 A operands with f32 sums hold row 7's bf16 gate
against the plain backward, hi alone misses it.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blockwise_attention
from repro_torch.configs import ShapeCell, get_config, list_archs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.steps import build_train_step

HEAD_DIMS = (16, 32, 64, 96, 128, 160, 256)
TC_HEAD_DIMS = (64, 96, 128, 160, 256)
# trainable archs whose head dim the tensor-core backward lacks (none since
# hd 256 took the tensor cores); an entry would name the arch and its head dim
CUDA_CORE_TRAINING: dict = {}


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_path_at_every_dtype_and_head_dim(dtype, hd):
    """bf16 at 64, 96, 128, 160 and 256 takes the tensor cores; f32 at
    every head dim and bf16 at 16 and 32 take the CUDA-core build."""
    tc = dtype == torch.bfloat16 and hd in TC_HEAD_DIMS
    assert fa_ops.flash_attention_bwd_path(dtype, hd) == ("tensor_cores" if tc else "cuda_cores")
    assert fa_ops._HEAD_DIMS == HEAD_DIMS


@pytest.mark.parametrize("arch", list_archs())
def test_every_trainable_arch_takes_the_tensor_cores_in_bf16(arch):
    """Every arch trains, in bf16, and its head dim takes the tensor-core
    backward, except the archs named in ``CUDA_CORE_TRAINING``, which take
    the CUDA-core build at the head dim named there; the ``ssm`` archs
    (Mamba-2) have no attention layer and train through kernel 11's
    backward, whose coverage holds their state size and head dim."""
    cfg = get_config(arch)
    assert cfg.dtype == "bfloat16"
    build_train_step(cfg, "cpu", ShapeCell("t", 8, 1, "train"))  # no refusal
    if "ssm" in cfg.layer_kinds:
        assert set(cfg.layer_kinds) == {"ssm"}
        assert cfg.ssm_state <= ssd_ops.NMAX and cfg.ssm_head_dim <= ssd_ops.PMAX
        assert cfg.ssm_state % 4 == 0 and cfg.ssm_head_dim % 4 == 0
        return
    hd = cfg.resolved_head_dim
    want = "cuda_cores" if CUDA_CORE_TRAINING.get(arch) == hd else "tensor_cores"
    assert fa_ops.flash_attention_bwd_path(torch.bfloat16, hd) == want
    assert hd in HEAD_DIMS


def _inputs(B, S, nq, nkv, hd, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, S, nq, hd)).astype(np.float32)).to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, nkv, hd)).astype(np.float32)).to(dtype) for _ in range(2))
    return q, k, v, do


@pytest.fixture
def no_library(monkeypatch):
    def refuse(*args):
        raise AssertionError("a library was asked for")

    monkeypatch.setattr(fa_ops, "function", refuse)
    monkeypatch.setattr(fa_ops, "stream_of", lambda t: 0)  # no CUDA stream on the CPU


@pytest.mark.parametrize("hd", [8, 48, 80, 112, 192, 320])
def test_head_dims_outside_the_builds_are_refused(hd, no_library):
    """The path names no build, and the launch raises before any library
    is built or loaded; the CPU wrapper still runs the plain version."""
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=f"head_dim {hd} not in"):
            fa_ops.flash_attention_bwd_path(dtype, hd)
        q, k, v, do = _inputs(1, 5, 2, 1, hd, dtype)
        out, lse = fa_ref.flash_attention_lse(q, k, v)
        with pytest.raises(ValueError, match=f"head_dim {hd} not in"):
            fa_ops._launch_bwd(q, k, v, out, lse, do, True, 0)
        got = fa_ops.flash_attention_bwd_kernel(q, k, v, out, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(got, fa_ref.flash_attention_bwd(q, k, v, out, lse, do)))


def test_what_neither_build_takes_is_refused(no_library):
    """A dtype neither build has, a query group above 64 heads,
    non-contiguous tensors, and (the tensor cores' TMA) a base that is not
    16-byte aligned: each raises before any library is asked for.  The
    CUDA-core build reads unaligned f32 tensors."""
    q, k, v, do = _inputs(1, 9, 2, 1, 64, torch.float16)
    with pytest.raises(ValueError, match="neither float32 nor bfloat16"):
        fa_ops.flash_attention_bwd_path(torch.float16, 64)
    lse = torch.zeros((1, 9, 2))
    with pytest.raises(ValueError, match="neither float32 nor bfloat16"):
        fa_ops._launch_bwd(q, k, v, q, lse, do, True, 0)
    q, k, v, do = _inputs(1, 9, 65, 1, 64)
    with pytest.raises(ValueError, match="query group of 65 heads"):
        fa_ops._launch_bwd(q, k, v, q, torch.zeros((1, 9, 65)), do, True, 0)
    q, k, v, do = _inputs(1, 9, 4, 2, 128)
    lse = torch.zeros((1, 9, 4))
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops._launch_bwd(q, k, v, q, lse, do.transpose(1, 2).contiguous().transpose(1, 2), True, 0)
    shifted = torch.zeros((q.numel() + 1,), dtype=q.dtype)[1:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_ops._launch_bwd(shifted, k, v, q, lse, do, True, 0)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    shifted32 = torch.zeros((q.numel() + 1,))[1:].view(q.shape)
    with pytest.raises(AssertionError, match="a library was asked for"):
        fa_ops._launch_bwd(shifted32, k32, v32, q32, lse, do32, True, 0)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64), (torch.bfloat16, 160), (torch.float32, 128),
                                      (torch.bfloat16, 256), (torch.float32, 256)])
def test_each_build_launches_its_own_entry_with_its_scratch(dtype, hd, monkeypatch):
    """The launch calls the C entry of the build the path names, once,
    with the shapes, the mask and 1 / sqrt(hd), and a scratch of the size
    that build's layout takes (the tensor cores: lse and D per head over
    positions padded to 64, then the per-head partial dK and dV)."""
    B, S, nq, nkv = 2, 70, 8, 2
    calls, sizes = [], []
    empty = torch.empty

    def record_empty(*shape, **kw):
        t = empty(*shape, **kw)
        sizes.append(t.numel())
        return t

    def fake(name, symbol, argtypes):
        def launch(*args):
            calls.append((name, symbol, len(argtypes), args))
            return 0
        return launch

    monkeypatch.setattr(fa_ops, "function", fake)
    monkeypatch.setattr(fa_ops, "stream_of", lambda t: 0)  # no CUDA stream on the CPU
    monkeypatch.setattr(fa_ops.torch, "empty", record_empty)
    q, k, v, do = _inputs(B, S, nq, nkv, hd, dtype)
    lse = torch.zeros((B, S, nq))
    fa_ops._launch_bwd(q, k, v, q, lse, do, True, 17)
    path = fa_ops.flash_attention_bwd_path(dtype, hd)
    [(name, symbol, nargs, args)] = calls
    assert name == "flash_attention_bwd" and nargs == len(args)
    if path == "tensor_cores":
        assert symbol == "repro_flash_attention_bwd_tc" and nargs == 20
        Sp = 128
        assert sizes == [2 * B * nq * Sp + 2 * B * S * nq * hd]
    else:
        assert symbol == "repro_flash_attention_bwd" and nargs == 21 and args[0] == int(dtype == torch.bfloat16)
        assert sizes == [B * S * nq]
    assert args[-10:-2] == (B, S, S, nq, nkv, hd, 1, 17) and args[-2] == pytest.approx(1 / math.sqrt(hd))
    assert args[-1] == 0
    assert fa_ops.bwd_scratch_floats(path, B, S, S, nq, hd) == sizes[0]


# B, S, nq, nkv, hd, window: the tensor-core head dims at groups 8, 1, 12, 4
# and (RecurrentGemma-2B's) 10
JAX_CASES = {"hd64_g8": (1, 70, 16, 2, 64, 0), "hd96_g1_w33": (2, 50, 2, 2, 96, 33),
             "hd128_g12": (1, 45, 12, 1, 128, 0), "hd160_g4_w20": (1, 66, 8, 2, 160, 20),
             "hd256_g10_w40": (1, 70, 10, 1, 256, 40)}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_plain_backward_matches_jax_vjp_at_the_tensor_core_shapes(case):
    """f32 inputs: the port's plain backward (the version the card's
    kernel is held against) on its own forward's O and lse, against
    ``jax.vjp`` of the reference's ``blockwise_attention`` (causal, the
    window), within 1e-4 of each gradient's largest magnitude (f32 sums
    in other orders)."""
    B, S, nq, nkv, hd, window = JAX_CASES[case]
    q, k, v, do = _inputs(B, S, nq, nkv, hd, torch.float32, seed=S)
    out, lse = fa_ref.flash_attention_lse(q, k, v, causal=True, window=window)
    got = fa_ref.flash_attention_bwd(q, k, v, out, lse, do, causal=True, window=window)
    fwd = lambda a, b, c: blockwise_attention(a, b, c, causal=True, local_window=window)  # noqa: E731
    _, vjp = jax.vjp(fwd, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max()))


def _split(x: torch.Tensor, lo: bool) -> torch.Tensor:
    """x as the kernel carries it into an A operand: bf16(x) + bf16(x -
    bf16(x)), or bf16(x) alone."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if lo else hi


def _emulate_tc(q, k, v, out, lse, do, causal, window, lo=True):
    """The tensor-core build's arithmetic in torch: S and dP in f32 from
    the bf16 inputs, P = exp2(S scale log2(e) - lse log2(e)), dS = P (dP -
    D) with D = rowsum(dO o O) in f32, P and dS split for the A operand, dV
    = P^T dO, dK = scale dS^T Q per query head (f32 partials, summed over
    each group in ascending head order), dQ = scale dS K; rounded to bf16."""
    B, S, nq, hd = q.shape
    nkv = k.shape[2]
    G = nq // nkv
    f = torch.float32
    log2e = 1.4426950408889634
    scale = 1.0 / math.sqrt(hd)
    kx, vx = (t.repeat_interleave(G, dim=2).to(f) for t in (k, v))
    s = torch.einsum("bqnh,bknh->bnqk", q.to(f), kx)
    i = torch.arange(S)[:, None]
    j = torch.arange(k.shape[1])[None, :]
    vis = torch.ones((S, k.shape[1]), dtype=torch.bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= i - j < window
    p = torch.exp2(s * (scale * log2e) - (lse * log2e).permute(0, 2, 1)[..., None]).masked_fill(~vis, 0.0)
    dp = torch.einsum("bqnh,bknh->bnqk", do.to(f), vx)
    d = (do.to(f) * out.to(f)).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - d)
    ps, dss = _split(p, lo), _split(ds, lo)
    dq = torch.einsum("bnqk,bknh->bqnh", dss, kx) * scale
    dk_h = torch.einsum("bnqk,bqnh->bknh", dss, q.to(f)) * scale
    dv_h = torch.einsum("bnqk,bqnh->bknh", ps, do.to(f))
    dk, dv = (t.reshape(B, -1, nkv, G, hd) for t in (dk_h, dv_h))
    dk_sum, dv_sum = dk[:, :, :, 0].clone(), dv[:, :, :, 0].clone()
    for g in range(1, G):
        dk_sum += dk[:, :, :, g]
        dv_sum += dv[:, :, :, g]
    return tuple(t.to(torch.bfloat16) for t in (dq, dk_sum, dv_sum))


def _misses(got, want) -> int:
    """Elements outside row 7's bf16 gate: 2^-7 |plain| + 1e-3 rms."""
    got, want = got.float(), want.float()
    lim = 2.0 ** -7 * want.abs() + 1e-3 * want.pow(2).mean().sqrt()
    return int(((got - want).abs() > lim).sum())


@pytest.mark.parametrize("hd,nq,nkv,window", [(128, 12, 1, 0), (160, 8, 2, 40), (256, 10, 1, 2048)])
def test_tensor_core_precision_needs_the_lo_halves_of_p_and_ds(hd, nq, nkv, window):
    """bf16 inputs on the plain backward's own O and lse: the emulated
    design with hi + lo P and dS holds the gate on every element of dQ,
    dK and dV; with hi alone it misses on each (dV through P, dQ and dK
    through dS)."""
    q, k, v, do = _inputs(1, 256, nq, nkv, hd, seed=hd)
    out, lse = fa_ref.flash_attention_lse(q, k, v, causal=True, window=window)
    want = fa_ref.flash_attention_bwd(q, k, v, out, lse, do, causal=True, window=window)
    both = _emulate_tc(q, k, v, out, lse, do, True, window)
    hi = _emulate_tc(q, k, v, out, lse, do, True, window, lo=False)
    assert [_misses(g, w) for g, w in zip(both, want)] == [0, 0, 0]
    assert all(_misses(g, w) > 0 for g, w in zip(hi, want))
