"""PyTorch port, kernel 7 at hd 64 (MusicGen-large's heads) on the CPU: the
C entry and argument types a bf16 hd 64 launch asks for (the tensor-core
build, serving and LSE) with ``fa_ops.function`` replaced by a recorder,
the refusal of a base that TMA cannot read before any library is asked for,
and the plain versions the card's build is held against
(``ref.flash_attention``, ``ref.flash_attention_lse``) against the JAX
package's Pallas kernel in interpret mode at MusicGen's layout (one query
head a KV head, hd 64): causal and windowed, ragged last tiles.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref


def _inputs(B, S, nq, nkv, dtype=torch.bfloat16, seed=0, hd=64):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, S, nq, hd)).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, nkv, hd)).astype(np.float32)).to(dtype) for _ in range(2))
    return q, k, v


@pytest.fixture
def recorder(monkeypatch):
    """``fa_ops.function`` replaced: each launch appends (library, symbol,
    argtypes, args) and returns 0; no stream on the CPU."""
    calls = []

    def fake(name, symbol, argtypes):
        def launch(*args):
            calls.append((name, symbol, list(argtypes), args))
            return 0
        return launch

    monkeypatch.setattr(fa_ops, "function", fake)
    monkeypatch.setattr(fa_ops, "stream_of", lambda t: 0)
    return calls


@pytest.mark.parametrize("lse", [False, True])
def test_bf16_hd64_launch_asks_for_the_tensor_core_entry(recorder, lse):
    """bf16 at hd 64 calls ``repro_flash_attention_tc`` (serving) or
    ``repro_flash_attention_tc_lse`` (training) once, with no dtype code,
    pointers then the shapes, the mask and 1 / sqrt(64); the LSE launch
    passes its (B, Sq, nq) f32 output after out."""
    B, S, nq, nkv = 2, 70, 32, 32
    q, k, v = _inputs(B, S, nq, nkv)
    got = fa_ops._launch_prefill(q, k, v, True, 17, lse=lse)
    [(name, symbol, argtypes, args)] = recorder
    assert name == "flash_attention"
    assert symbol == "repro_flash_attention_tc" + ("_lse" if lse else "")
    assert argtypes == (fa_ops._FA_TC_LSE_ARGTYPES if lse else fa_ops._FA_TC_ARGTYPES)
    n_ptr = 5 if lse else 4
    assert argtypes[:n_ptr] == [fa_ops.ctypes.c_void_p] * n_ptr and len(args) == len(argtypes)
    out = got[0] if lse else got
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()) + ((got[1].data_ptr(),) if lse else ())
    assert args[:n_ptr] == ptrs
    assert args[n_ptr:-2] == (B, S, S, nq, nkv, 64, 1, 17)
    assert args[-2] == pytest.approx(1 / math.sqrt(64)) and args[-1] == 0
    if lse:
        assert got[1].shape == (B, S, nq) and got[1].dtype == torch.float32


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64), (torch.bfloat16, 32), (torch.bfloat16, 16)])
def test_cuda_core_builds_keep_their_entry(recorder, dtype, hd):
    """f32 at hd 64 and bf16 at 32 and 16 stay on ``repro_flash_attention``
    with their dtype code first."""
    q, k, v = _inputs(1, 40, 8, 2, dtype, hd=hd)
    fa_ops._launch_prefill(q, k, v, True, 0)
    [(_, symbol, argtypes, args)] = recorder
    assert symbol == "repro_flash_attention" and argtypes == fa_ops._FA_ARGTYPES
    assert args[0] == fa_ops.dtype_code(dtype) and args[-5] == hd


def test_bf16_hd64_refuses_an_unaligned_base(monkeypatch):
    """TMA reads 16-byte-aligned bases only: q, k or v shifted by one
    element raises before any library is asked for, serving and LSE."""
    def refuse(*args):
        raise AssertionError("a library was asked for")

    monkeypatch.setattr(fa_ops, "function", refuse)
    monkeypatch.setattr(fa_ops, "stream_of", lambda t: 0)
    q, k, v = _inputs(1, 33, 4, 4)
    for i in range(3):
        args = [q, k, v]
        shifted = torch.zeros((args[i].numel() + 1,), dtype=torch.bfloat16)[1:].view(args[i].shape)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
        args[i] = shifted
        for lse in (False, True):
            with pytest.raises(ValueError, match="16-byte aligned"):
                fa_ops._launch_prefill(*args, True, 0, lse=lse)


# B, S, nq (= nkv), causal, window: MusicGen's layout (G = 1), S ragged
# against the 16-row blocks of the reference and the 64-key tiles of the card
JAX_CASES = {"causal": (1, 70, 4, True, 0), "causal_w33": (2, 97, 3, True, 33),
             "full": (1, 53, 2, False, 0), "full_w21": (1, 45, 2, False, 21), "heads32": (1, 37, 32, True, 0)}


def _j_lse(q, k, causal, window):
    """The rows' log-sum-exp of their scaled scores in jnp (f32)."""
    qj, kj = (jnp.asarray(t.float().numpy()) for t in (q, k))
    s = jnp.einsum("bqnh,bknh->bnqk", qj, kj) / math.sqrt(q.shape[-1])
    i, j = jnp.arange(q.shape[1])[:, None], jnp.arange(k.shape[1])[None, :]
    vis = jnp.ones(s.shape[-2:], bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= i - j < window
    return np.asarray(jax.nn.logsumexp(jnp.where(vis, s, -jnp.inf), axis=-1).transpose(0, 2, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_plain_versions_match_jax_pallas_at_musicgen_layout(case, dtype):
    """The port's plain forward and its LSE form against the JAX package's
    ``flash_attention`` (Pallas, interpret mode, blocks of 16): f32 at
    1e-5; bf16 inputs are rounded once on both sides and the port's output
    rounded to bf16: one bf16 ulp (2^-7).  The LSE form's output is the
    plain forward's bitwise, and its log-sum-exps are jnp's within 1e-5 of
    their scale (f32 sums in another order)."""
    B, S, nh, causal, window = JAX_CASES[case]
    q, k, v = _inputs(B, S, nh, nh, dtype, seed=S)
    got = fa_ref.flash_attention(q, k, v, causal=causal, window=window)
    out, lse = fa_ref.flash_attention_lse(q, k, v, causal=causal, window=window)
    assert torch.equal(out, got)
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    want = np.asarray(j_flash_attention(jq, jk, jv, causal=causal, window=window, bq=16, bkv=16, interpret=True))
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    want_lse = _j_lse(q, k, causal, window)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5 * max(1.0, float(np.abs(want_lse).max())), rtol=0)
