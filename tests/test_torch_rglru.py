"""PyTorch port, RG-LRU: the recurrent block and the plain version of the
``rglru_scan`` kernel against the JAX reference, on the CPU.

Gates (atol 1e-5, f32): ``rec_block_prefill`` (output and final state) and
``rec_block_decode`` against ``repro.models.rglru`` with random gates; the
plain scan against the reference's Pallas kernel in interpret mode and its
``linear_scan`` oracle, with and without ``h0``, T not a multiple of the
kernel's time block.  The reference scans associatively and the port
loops, so the sums run in another order.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels.rglru_scan import rglru_scan as j_rglru_scan
from repro.models import rglru as JR
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels.rglru_scan import ops, ref
from repro_torch.models import rglru as TR

ARCH = "recurrentgemma-2b"
TOL = 1e-5


def _block(seed):
    """Reference block params with random (not init-value) gates, as numpy."""
    cfg = j_smoke(ARCH)
    p = {k: np.array(v) for k, v in JR.init_rec_block(jax.random.PRNGKey(seed), cfg).items()}
    rng = np.random.default_rng(seed)
    w = cfg.lru_width
    p["alpha_r"] = rng.uniform(0.5, 1.5, w).astype(np.float32)
    p["alpha_i"] = rng.uniform(0.5, 1.5, w).astype(np.float32)
    p["b_r"] = (0.3 * rng.standard_normal(w)).astype(np.float32)
    p["b_i"] = (0.3 * rng.standard_normal(w)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(w)).astype(np.float32)
    return cfg, p


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("T", [1, 3, 37])
def test_rec_block_prefill_matches_reference(T):
    cfg, p = _block(0)
    x = np.random.default_rng(1).standard_normal((2, T, cfg.d_model)).astype(np.float32)
    jy, jstate = JR.rec_block_prefill(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, cfg)
    ty, tstate = TR.rec_block_prefill(_t(x), {k: _t(v) for k, v in p.items()}, t_smoke(ARCH))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tstate["h"].numpy(), np.asarray(jstate["h"]), atol=TOL, rtol=TOL)
    K = cfg.conv1d_width
    if T >= K - 1:  # a shorter prompt changes the reference's conv-state shape
        np.testing.assert_allclose(tstate["conv"].numpy(), np.asarray(jstate["conv"]), atol=TOL, rtol=TOL)
    else:
        assert tstate["conv"].shape == (2, K - 1, cfg.lru_width)
        np.testing.assert_array_equal(tstate["conv"][:, K - 1 - T:].numpy(), np.asarray(jstate["conv"]))


def test_rec_block_decode_steps_match_reference():
    """Six decode steps from a prefilled state: output and state every step."""
    cfg, p = _block(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 9, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    tcfg = t_smoke(ARCH)
    _, jstate = JR.rec_block_prefill(jnp.asarray(x), jp, cfg)
    _, tstate = TR.rec_block_prefill(_t(x), tp, tcfg)
    for step in range(6):
        xs = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jy, jstate = JR.rec_block_decode(jnp.asarray(xs), jp, cfg, jstate)
        ty = TR.rec_block_decode(_t(xs), tp, tcfg, tstate)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL, err_msg=f"step {step}")
        for name in ("h", "conv"):
            np.testing.assert_allclose(tstate[name].numpy(), np.asarray(jstate[name]), atol=TOL, rtol=TOL,
                                       err_msg=f"step {step} {name}")


def test_init_rec_state_types():
    cfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16")
    st = TR.init_rec_state(2, cfg, "cpu")
    assert st["h"].dtype == torch.float32 and st["h"].shape == (2, cfg.lru_width)
    assert st["conv"].dtype == torch.bfloat16 and st["conv"].shape == (2, cfg.conv1d_width - 1, cfg.lru_width)


def _scan_inputs(seed, B, T, W):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, T, W)).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, T, W))).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,W", [(1, 37, 64), (3, 50, 24)])
def test_plain_scan_matches_pallas_interpret_and_linear_scan(B, T, W, with_h0):
    """T not a multiple of the kernel's time block (bt=16 here), W not a
    multiple of its channel block (bw=16 against W=24)."""
    a, b, h0 = _scan_inputs(B * T, B, T, W)
    jh0 = jnp.asarray(h0) if with_h0 else None
    got = ops.rglru_scan(_t(a), _t(b), _t(h0) if with_h0 else None)
    assert got.dtype == torch.float32 and got.shape == (B, T, W)
    kern = j_rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0, bt=16, bw=16, interpret=True)
    oracle = JR.linear_scan(jnp.asarray(a), jnp.asarray(b), h0=jh0)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=TOL, rtol=TOL)


def test_scan_wrapper_checks_and_bf16_inputs():
    a, b, h0 = _scan_inputs(5, 2, 7, 8)
    with pytest.raises(ValueError, match="must be"):
        ops.rglru_scan(_t(a), _t(b[:, :3]))
    with pytest.raises(ValueError, match="h0 shape"):
        ops.rglru_scan(_t(a), _t(b), _t(h0[:1]))
    # bf16 inputs are read as f32: the same as casting them first
    ab, bb = _t(a).to(torch.bfloat16), _t(b).to(torch.bfloat16)
    torch.testing.assert_close(ops.rglru_scan(ab, bb, _t(h0)), ref.linear_scan(ab.float(), bb.float(), _t(h0)),
                               rtol=0, atol=0)
