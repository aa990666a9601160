"""PyTorch port, Mamba-2: the SSD block and the plain version of the
``ssd_scan`` kernel against the JAX reference, on the CPU.

Gates (f32): ``ssm_block`` (output, final ``h``, ``conv`` tail) and
``ssm_block_decode`` against ``repro.models.mamba2`` with random (not
init-value) ``A_log``/``D``/``dt_bias``/``norm_scale``, at atol/rtol 1e-5,
with the chunk at 16 so several chunks carry a state; the plain scan
against the reference's Pallas kernel in interpret mode and its
``ssd_chunked`` oracle, with and without ``h0``, T not a multiple of the
chunk, at 2e-5 (the reference's own kernel-vs-oracle tolerance:
``tests/test_kernels.py::test_ssd_scan_sweep``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels.ssd_scan import ops as j_ops
from repro.models import mamba2 as JM
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import mamba2 as TM

ARCH = "mamba2-2.7b"
TOL = 1e-5
SCAN_TOL = 2e-5


def _block(seed):
    """Reference block params with random leaves, as numpy; the chunk is 16."""
    cfg = j_smoke(ARCH)
    assert cfg.ssm_chunk == 16
    p = {k: np.array(v) for k, v in JM.init_ssm_block(jax.random.PRNGKey(seed), cfg).items()}
    rng = np.random.default_rng(seed)
    d_in, H, P, N = JM.dims(cfg)
    p["A_log"] = rng.uniform(0.0, np.log(16.0), H).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, H).astype(np.float32)
    p["dt_bias"] = rng.uniform(-4.0, 0.5, H).astype(np.float32)
    p["norm_scale"] = (0.3 * rng.standard_normal(d_in)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)).astype(np.float32)
    return cfg, p


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("T", [1, 3, 37, 300])
def test_ssm_block_prefill_matches_reference(T):
    cfg, p = _block(0)
    x = np.random.default_rng(T).standard_normal((2, T, cfg.d_model)).astype(np.float32)
    jy, jstate = JM.ssm_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, cfg, return_state=True)
    ty, tstate = TM.ssm_block(_t(x), {k: _t(v) for k, v in p.items()}, t_smoke(ARCH), return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tstate["h"].numpy(), np.asarray(jstate["h"]), atol=TOL, rtol=TOL)
    K = cfg.conv1d_width
    if T >= K - 1:  # a shorter prompt changes the reference's conv-state shape
        np.testing.assert_allclose(tstate["conv"].numpy(), np.asarray(jstate["conv"]), atol=TOL, rtol=TOL)
    else:
        assert tstate["conv"].shape == (2, K - 1, jstate["conv"].shape[-1])
        np.testing.assert_array_equal(tstate["conv"][:, K - 1 - T:].numpy(), np.asarray(jstate["conv"]))
        assert not tstate["conv"][:, :K - 1 - T].any()


def test_ssm_block_decode_steps_match_reference():
    """Six decode steps from a prefilled state: output and state every step."""
    cfg, p = _block(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 21, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    tcfg = t_smoke(ARCH)
    _, jstate = JM.ssm_block(jnp.asarray(x), jp, cfg, return_state=True)
    _, tstate = TM.ssm_block(_t(x), tp, tcfg, return_state=True)
    for step in range(6):
        xs = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jy, jstate = JM.ssm_block_decode(jnp.asarray(xs), jp, cfg, jstate)
        ty = TM.ssm_block_decode(_t(xs), tp, tcfg, tstate)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL, err_msg=f"step {step}")
        for name in ("h", "conv"):
            np.testing.assert_allclose(tstate[name].numpy(), np.asarray(jstate[name]), atol=TOL, rtol=TOL,
                                       err_msg=f"step {step} {name}")


def test_init_ssm_block_and_state_match_reference_layout():
    """Same leaves, shapes and deterministic values (A_log, D, dt_bias,
    norm_scale, conv_b) as the reference; f32 leaves stay f32 in bf16."""
    jcfg = j_smoke(ARCH)
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16")
    jp = JM.init_ssm_block(jax.random.PRNGKey(0), jcfg)
    tp = TM.init_ssm_block(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert list(tp) == list(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
    for k in ("A_log", "D", "dt_bias", "norm_scale"):
        assert tp[k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-7, rtol=1e-6, err_msg=k)
    assert {tp[k].dtype for k in ("w_in", "conv_w", "conv_b", "w_out")} == {torch.bfloat16}
    assert not tp["conv_b"].float().any()
    st = TM.init_ssm_state(2, tcfg, "cpu")
    js = JM.init_ssm_state(2, jcfg)
    assert st["h"].dtype == torch.float32 and tuple(st["h"].shape) == js["h"].shape
    assert st["conv"].dtype == torch.bfloat16 and tuple(st["conv"].shape) == js["conv"].shape


def _scan_inputs(seed, B, T, H, P, N):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((B, T, H, P))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    bm = (0.3 * rng.standard_normal((B, T, N))).astype(np.float32)
    cm = (0.3 * rng.standard_normal((B, T, N))).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H, N, P))).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("B,T,H,P,N,Q", [(2, 96, 3, 16, 24, 32), (1, 70, 2, 8, 16, 32), (2, 100, 2, 32, 64, 64)])
def test_plain_scan_matches_pallas_interpret_and_ssd_chunked(B, T, H, P, N, Q):
    """The reference kernel's sweep and its ragged-tail case (T = 70 over
    chunks of 32): y and the final state against ``ssd_scan_pallas`` in
    interpret mode (no ``h0``: the TPU kernel starts from zeros) and against
    ``ssd_chunked``."""
    x, dt, a, bm, cm, _ = _scan_inputs(T + N, B, T, H, P, N)
    y, h = ops.ssd_scan(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk=Q)
    assert y.dtype == h.dtype == torch.float32 and y.shape == (B, T, H, P) and h.shape == (B, H, N, P)
    jargs = tuple(jnp.asarray(v) for v in (x, dt, a, bm, cm))
    yk, hk = j_ops.ssd_scan(*jargs, chunk=Q, interpret=True)
    yr, hr = JM.ssd_chunked(*jargs, Q)
    for want_y, want_h in ((yk, hk), (yr, hr)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=SCAN_TOL, rtol=SCAN_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("T,Q", [(37, 16), (48, 16), (5, 16)])
def test_plain_scan_with_h0_matches_ssd_chunked(T, Q):
    x, dt, a, bm, cm, h0 = _scan_inputs(T, 2, T, 3, 8, 16)
    y, h = ops.ssd_scan(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk=Q, h0=_t(h0))
    yr, hr = JM.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), Q, h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=TOL, rtol=TOL)


def test_plain_scan_splits_into_chunks_and_states():
    """Scanning t[:k] and then t[k:] from its final state equals scanning t:
    the state carries the whole prefix (the decode contract of prefill)."""
    x, dt, a, bm, cm, _ = _scan_inputs(9, 1, 53, 2, 8, 16)
    args = [_t(v) for v in (x, dt, a, bm, cm)]
    y, h = ref.ssd_chunked(*args, 16)
    k = 21
    y1, h1 = ref.ssd_chunked(*(v[:, :k] for v in args[:2]), args[2], *(v[:, :k] for v in args[3:]), 16)
    y2, h2 = ref.ssd_chunked(*(v[:, k:] for v in args[:2]), args[2], *(v[:, k:] for v in args[3:]), 16, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=TOL, rtol=TOL)
    torch.testing.assert_close(h2, h, atol=TOL, rtol=TOL)


def test_scan_wrapper_checks_and_bf16_inputs():
    x, dt, a, bm, cm, h0 = _scan_inputs(5, 1, 7, 2, 8, 16)
    with pytest.raises(ValueError, match="dt"):
        ops.ssd_scan(_t(x), _t(dt[:, :3]), _t(a), _t(bm), _t(cm))
    with pytest.raises(ValueError, match="h0 shape"):
        ops.ssd_scan(_t(x), _t(dt), _t(a), _t(bm), _t(cm), h0=_t(h0[:, :1]))
    # bf16 inputs are read as f32: the same as casting them first
    xb, bb, cb = (_t(v).to(torch.bfloat16) for v in (x, bm, cm))
    got = ops.ssd_scan(xb, _t(dt), _t(a), bb, cb, chunk=4)
    want = ref.ssd_chunked(xb.float(), _t(dt), _t(a), bb.float(), cb.float(), 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
