"""PyTorch port, kernel 12's chunked scan on the CPU: its order of
operations, emulated in plain torch, against the JAX reference.

The card's kernel (``csrc/rglru_scan.cu``) splits T into chunks of
``ops.CHUNK`` steps and each chunk into segments of ``ops.SEGMENT`` steps:
(i) each segment's aggregate from 0 (A = the product of its a, H = its scan
from 0); (ii) each chunk's aggregate, its segments' folded in ascending
order; (iii) the carry into chunk c, h0 (or 0) folded with chunks 0..c-1's
aggregates in ascending order, h = A h + H; (iv) each segment walked again
from the chunk's carry folded with the segments before it.  Every update is
one f32 FMA (emulated here with the product exact in f64 and the sum
rounded to f64, then f32), every product of a one f32 multiply.  Held
against the reference's Pallas kernel in interpret mode and its
``linear_scan`` oracle at T around the chunk length, W not a multiple of
the kernel's 128-channel tile, with and without h0, and at gates whose chunk
product underflows to 0 or that are exactly 1.  Also asserts the build
choice (``rglru_scan_path``) and the scratch's size.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import rglru_scan as j_rglru_scan
from repro.models import rglru as JR
from repro_torch.kernels.rglru_scan import ops

TOL = 1e-5
L, S = ops.CHUNK, ops.SEGMENT
Bn, W = 2, 24


def _fma(a, h, b):
    """One f32 fused multiply-add: a*h exact in f64, one rounding of the sum."""
    return (a.double() * h.double() + b.double()).float()


def _fold(aggs, h):
    """h folded with (A, H) aggregates in ascending order: h = A h + H."""
    for A, H in aggs:
        h = _fma(A, h, H)
    return h


def chunked_scan(a, b, h0=None):
    """The kernel's order of operations over (B, T, W) f32 a, b."""
    B, T, W_ = a.shape
    G = L // S
    segs = []
    for t0 in range(0, T, S):
        A, H = a[:, t0], b[:, t0]
        for t in range(t0 + 1, min(T, t0 + S)):
            H = _fma(a[:, t], H, b[:, t])
            A = a[:, t] * A
        segs.append((A, H))
    nc = -(-T // L)
    chunks = []
    for c in range(nc - 1):  # the last chunk's aggregate is never needed
        A, H = segs[c * G]
        for Aw, Hw in segs[c * G + 1:(c + 1) * G]:
            H = _fma(Aw, H, Hw)
            A = Aw * A
        chunks.append((A, H))
    out = torch.empty((B, T, W_), dtype=torch.float32)
    for c in range(nc):
        carry = _fold(chunks[:c], torch.zeros((B, W_)) if h0 is None else h0)
        for k in range(c * G, min(len(segs), (c + 1) * G)):
            h = _fold(segs[c * G:k], carry)
            for t in range(k * S, min(T, k * S + S)):
                h = _fma(a[:, t], h, b[:, t])
                out[:, t] = h
    return out, chunks


def _gates(seed, T):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (Bn, T, W)).astype(np.float32)
    b = (0.1 * rng.standard_normal((Bn, T, W))).astype(np.float32)
    h0 = rng.standard_normal((Bn, W)).astype(np.float32)
    return a, b, h0


def _hold(a, b, h0):
    """The emulated kernel against the Pallas kernel (interpret mode) and
    linear_scan; returns the emulation's chunk aggregates."""
    got, chunks = chunked_scan(torch.from_numpy(a), torch.from_numpy(b), None if h0 is None else torch.from_numpy(h0))
    jh0 = None if h0 is None else jnp.asarray(h0)
    kern = j_rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0, bt=16, bw=16, interpret=True)
    oracle = JR.linear_scan(jnp.asarray(a), jnp.asarray(b), h0=jh0)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=TOL, rtol=TOL)
    return chunks


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T", [1, L - 1, L, L + 1, 3 * L + 5])
def test_chunked_order_matches_pallas_interpret_and_linear_scan(T, with_h0):
    a, b, h0 = _gates(T, T)
    _hold(a, b, h0 if with_h0 else None)


@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_order_holds_at_underflowing_and_unit_gates(with_h0):
    """Channels 0-7: a = 0.05, so a chunk's product (0.05^128) underflows to
    0 and each carry restarts at the chunk's H; channels 8-15: a = 1
    exactly, a running sum; the rest random."""
    T = 3 * L + 5
    a, b, h0 = _gates(7, T)
    a[:, :, :8] = 0.05
    a[:, :, 8:16] = 1.0
    chunks = _hold(a, b, h0 if with_h0 else None)
    for A, _ in chunks:
        assert bool((A[:, :8] == 0).all()) and bool((A[:, 8:16] == 1).all())


def test_build_choice_and_scratch():
    """Four channels a lane (16 bytes of f32, 8 of bf16) where W is a
    multiple of 4 and both bases are aligned to 4 elements, else one channel
    a lane; the scratch holds the ticket, a flag a (batch row, chunk, tile)
    padded to 16 bytes, and 2 W floats a (batch row, chunk)."""
    assert ops.rglru_scan_path(2560, True) == "vector" and ops.rglru_scan_path(100, True) == "vector"
    assert ops.rglru_scan_path(102, True) == "scalar"   # not a multiple of 4
    assert ops.rglru_scan_path(2560, False) == "scalar"
    assert ops.LANE_CHANNELS == 4
    # RecurrentGemma-2B's admission: 32 chunks x 20 tiles of 128 channels
    assert ops.scratch_words(1, 4096, 2560, 4) == 644 + 32 * 2 * 2560
    assert ops.scratch_words(2, 1, 24, 1) == 4 + 2 * 2 * 24
