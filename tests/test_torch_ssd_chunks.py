"""PyTorch port, kernel 11's tensor-core build on the CPU: its precision
design, emulated in plain torch, against the JAX reference.

The card's bf16 build (``csrc/ssd_scan.cu``, namespace ``tc``) splits the
scan over chunks of ``ops.TC_CHUNK`` rows in three phases: (i) each chunk's
own state ``s_c = (B o w)^T x``, ``w = exp(cum_last - cum) dt``; (ii) the
states entering each chunk, ``h_c = exp(cum_last,c) h_{c-1} + s_c``; (iii)
``y = (C B^T o causal decay o dt) x + exp(cum) C h_{c-1}``.  Its products
take bf16 operands with f32 sums; each f32 operand (``w o x``, the entering
state ``h``, the scaled tile ``S``) is carried as ``hi = bf16(v)`` plus
``lo = bf16(v - hi)``; the chunk's cumsum of ``dt * a`` is taken in f64.
Emulated here with those roundings (every other value in f32), at a reduced shape with a ragged second chunk, it holds the
card's gate (1e-4 of the output scale, on y and on the final state) against
the reference's Pallas kernel in interpret mode and its ``ssd_chunked``
oracle; without the lo halves it misses that gate.  Also asserts the two
build choices this slice adds (``ssd_scan_path``, ``gather_swiglu_path``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as j_ops
from repro.models import mamba2 as JM
from repro_torch.kernels.moe_fused import ops as mf_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

GATE = 1e-4  # of max(1, max |reference|): the card's gate on y and on the final state
B, T, H, P, N = 2, 300, 3, 32, 64


def _split(v: torch.Tensor, lo_halves: bool):
    """hi = bf16(v), lo = bf16(v - hi) (zero without the lo halves), as f32."""
    hi = v.to(torch.bfloat16).float()
    lo = (v - hi).to(torch.bfloat16).float() if lo_halves else torch.zeros_like(v)
    return hi, lo


def _tc_scan(x, dt, a, bm, cm, h0, lo_halves=True):
    """The three phases over chunks of ``TC_CHUNK`` rows with the tensor-core
    build's roundings; x, B and C hold bf16 values (the kernel's inputs)."""
    Q = ssd_ops.TC_CHUNK
    nc = -(-T // Q)
    pad = nc * Q - T
    xc = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)).reshape(B, nc, Q, H, P)
    dtc = torch.nn.functional.pad(dt, (0, 0, 0, pad)).reshape(B, nc, Q, H)  # dt 0 past T
    bc = torch.nn.functional.pad(bm, (0, 0, 0, pad)).reshape(B, nc, Q, N)
    cc = torch.nn.functional.pad(cm, (0, 0, 0, pad)).reshape(B, nc, Q, N)
    cum64 = torch.cumsum(dtc.double() * a.double(), dim=2)  # in f64; rows past T repeat the last cum
    cum, last = cum64.float(), cum64[:, :, -1].float()  # (B, nc, Q, H), (B, nc, H)
    # (i) chunk states: B^T (w o x), w o x split; the exponents taken in f64
    w = torch.exp((cum64[:, :, -1:] - cum64).float()) * dtc
    wx_hi, wx_lo = _split(w[..., None] * xc, lo_halves)
    s = torch.einsum("bcjn,bcjhp->bchnp", bc, wx_hi) + torch.einsum("bcjn,bcjhp->bchnp", bc, wx_lo)
    # (ii) state passing: the state entering each chunk, then the final state
    h = h0.clone()
    entering = []
    for c in range(nc):
        entering.append(h)
        h = torch.exp(last[:, c])[:, :, None, None] * h + s[:, c]
    # (iii) chunk outputs: exp(cum) C h_{c-1} with h split, plus S x with S split
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    ys = []
    for c in range(nc):
        h_hi, h_lo = _split(entering[c], lo_halves)
        y = torch.einsum("bin,bhnp->bihp", cc[:, c], h_hi) + torch.einsum("bin,bhnp->bihp", cc[:, c], h_lo)
        y = y * torch.exp(cum[:, c])[..., None]
        cb = torch.einsum("bin,bjn->bij", cc[:, c], bc[:, c])
        diff = (cum[:, c, :, None, :] - cum[:, c, None, :, :]).masked_fill(~causal[None, :, :, None], float("-inf"))
        sm = cb[..., None] * torch.exp(diff) * dtc[:, c, None, :, :]  # (B, Qi, Qj, H)
        s_hi, s_lo = _split(sm, lo_halves)
        y = y + torch.einsum("bijh,bjhp->bihp", s_hi, xc[:, c]) + torch.einsum("bijh,bjhp->bihp", s_lo, xc[:, c])
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, nc * Q, H, P)[:, :T], h


def _inputs(seed, with_h0):
    """The card's inputs at a reduced shape: bf16 x, B and C (as f32
    values), dt after softplus, the model's range of decays."""
    rng = np.random.default_rng(seed)
    bf = lambda v: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).float().numpy()  # noqa: E731
    x = bf(0.5 * rng.standard_normal((B, T, H, P)))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)) - 1.0)).astype(np.float32)
    a = -np.linspace(1.0, 16.0, H).astype(np.float32)
    bm, cm = (bf(0.3 * rng.standard_normal((B, T, N))) for _ in range(2))
    h0 = (rng.standard_normal((B, H, N, P)) if with_h0 else np.zeros((B, H, N, P))).astype(np.float32)
    return x, dt, a, bm, cm, h0


def _miss(got, want) -> float:
    """max |got - want| over the gate's allowance (<= 1 holds the gate)."""
    want = np.asarray(want, dtype=np.float32)
    return float(np.abs(got.numpy() - want).max()) / (GATE * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("with_h0", [False, True])
def test_emulated_tensor_core_scan_holds_the_gate_against_the_reference(with_h0):
    """From a zero state: against ``ssd_scan_pallas`` (interpret mode; the
    TPU kernel starts from zeros) and ``ssd_chunked``; from a random ``h0``:
    against ``ssd_chunked``.  Both at the model's chunk of 256."""
    x, dt, a, bm, cm, h0 = _inputs(7 + with_h0, with_h0)
    y, h = _tc_scan(*(torch.from_numpy(v) for v in (x, dt, a, bm, cm, h0)))
    jargs = tuple(jnp.asarray(v) for v in (x, dt, a, bm, cm))
    refs = [JM.ssd_chunked(*jargs, ssd_ops.TC_CHUNK, h0=jnp.asarray(h0))]
    if not with_h0:
        refs.append(j_ops.ssd_scan(*jargs, chunk=ssd_ops.TC_CHUNK, interpret=True))
    for want_y, want_h in refs:
        assert _miss(y, want_y) <= 1.0
        assert _miss(h, want_h) <= 1.0


def test_emulated_scan_without_lo_halves_misses_the_gate():
    """bf16 operands alone carry a 2^-9 relative error into y: the same
    emulation with every lo half zeroed misses the gate the hi + lo one
    holds (the card's build is held the same way in
    ``tests/test_torch_cuda_builds.py``)."""
    x, dt, a, bm, cm, h0 = _inputs(11, True)
    args = tuple(torch.from_numpy(v) for v in (x, dt, a, bm, cm, h0))
    want_y, want_h = JM.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), ssd_ops.TC_CHUNK,
                                    h0=jnp.asarray(h0))
    y, h = _tc_scan(*args)
    y_hi, h_hi = _tc_scan(*args, lo_halves=False)
    assert max(_miss(y, want_y), _miss(h, want_h)) <= 1.0
    assert _miss(y_hi, want_y) > 1.0


def test_build_choices_of_kernels_11_and_3():
    """Kernel 11: bf16 at Mamba-2-2.7B's N 128, P 64 read in place takes the
    tensor cores; this file's reduced shape does not.  Kernel 3: bf16 at
    Qwen3-MoE's d 4096, f 1536 takes the tensor cores; f = 84 (not a whole
    number of 16-byte pieces) does not."""
    assert ssd_ops.ssd_scan_path(torch.bfloat16, 128, 64, True) == "tensor_cores"
    assert ssd_ops.ssd_scan_path(torch.bfloat16, N, P, True) == "cuda_cores"
    assert mf_ops.gather_swiglu_path(torch.bfloat16, 4096, 1536, True) == "tensor_cores"
    assert mf_ops.gather_swiglu_path(torch.bfloat16, 96, 84, True) == "cuda_cores"
