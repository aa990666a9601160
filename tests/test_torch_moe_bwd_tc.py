"""PyTorch port, the tensor-core builds of kernels 3 and 4's training
backwards (``3_bwd``, ``4_bwd``; ``csrc/moe_fused_bwd.cu``, namespace
``tc``) on the CPU: which build a launch takes, the C entries' arguments and
scratch through a fake ``function`` (no card here), and the builds'
precision design emulated in plain torch against the JAX reference.

The card's bf16 build feeds every product bf16 operands with f32 sums.
Each f32 operand is carried as ``hi = bf16(v)`` plus ``lo = bf16(v - hi)``:
the slots' dy rows (``R = dy[idx]``, for dh and d slot_w), the weighted
rows ``slot_w R`` (for dWd) and dg, du (for dWg, dWu and dxs).  Emulated
here with those roundings at a ragged shape (C off the 64-slot units, an
expert with no token, dropped assignments), each backward holds the bf16
gate of ``chip_smoke.check_bf16`` (2^-7 |reference| + 1e-3 rms) on every
bf16 output and 1e-4 of the scale on d slot_w against ``jax.vjp`` of the
reference's composition (``dispatch -> local_experts_fn -> combine``,
``src/repro/core/control_plane.py``, ``src/repro/models/moe.py``) split at
h: 4_bwd against its down projection and combine, 3_bwd against its gate
and up projections over the dispatch.  Without any one lo half, an output
it feeds misses its gate.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import control_plane as jcp
from repro_torch import kernels
from repro_torch.core.control_plane import capacity_for, make_dispatch_plan
from repro_torch.kernels.moe_fused import ops as mf_ops

# T, d, f, E, k, capacity factor: C = 200, three units and a ragged fourth;
# expert 0 gets no token; the capacity drops assignments
T, D, F, E, K, CF = 600, 264, 200, 12, 4, 1.0


# ---------------------------------------------------------------------------
# build choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d,f", [(4096, 1536), (264, 200), (20, 200), (264, 36), (8, 8), (0, 8)])
def test_backward_paths_take_the_tensor_cores_for_aligned_bf16_at_multiples_of_8(dtype, aligned, d, f):
    want = ("tensor_cores" if dtype == torch.bfloat16 and aligned and d > 0 and d % 8 == 0 and f % 8 == 0
            else "cuda_cores")
    assert mf_ops.down_combine_bwd_path(dtype, f, d, aligned) == want
    assert mf_ops.gather_swiglu_bwd_path(dtype, d, f, aligned) == want


# ---------------------------------------------------------------------------
# the C entries, through a fake function
# ---------------------------------------------------------------------------

def _plan(rng, x):
    """Top-k of the router's softmax with expert 0 left out, through both
    packages' plan builders (numpy in between)."""
    logits = x @ rng.standard_normal((D, E)).astype(np.float32) * 0.5
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs[:, 0] = 0.0
    ids = np.argsort(-probs, axis=-1, kind="stable")[:, :K].astype(np.int32)
    w = np.take_along_axis(probs, ids, -1)
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    C = capacity_for(T, E, K, CF)
    tp = make_dispatch_plan(torch.from_numpy(ids), torch.from_numpy(w), E, C)
    jp = jcp.make_dispatch_plan(jnp.asarray(ids), jnp.asarray(w), E, C)
    assert np.array_equal(np.asarray(jp.flat_idx), tp.flat_idx.numpy())
    assert np.array_equal(np.asarray(jp.combine_idx), tp.combine_idx.numpy())
    return tp, jp


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    x = bf(rng.standard_normal((T, D)))
    tp, jp = _plan(rng, x.float().numpy())
    wg, wu = (bf(rng.standard_normal((E, D, F)) * D ** -0.5) for _ in range(2))
    wd = bf(rng.standard_normal((E, F, D)) * F ** -0.5)
    dy = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    return x, tp, jp, wg, wu, wd, dy


def test_inputs_are_ragged():
    x, tp, _, *_ = _inputs()
    C = tp.flat_idx.numel() // E
    assert C % mf_ops.BWD_UNIT != 0 and C > 2 * mf_ops.BWD_UNIT
    assert not bool((tp.flat_idx[:C] < T).any()), "expert 0 must get no token"
    assert bool((tp.flat_cidx == E * C).any()), "the capacity must drop an assignment"
    assert bool((tp.flat_idx[C:] == T).any()), "a used expert must have an empty slot"


def test_tensor_core_entries_take_their_arguments_and_scratch(monkeypatch):
    x, plan, _, wg, wu, wd, dy = _inputs()
    C = plan.flat_idx.numel() // E
    calls = []

    def fake(name, symbol, argtypes):
        def launch(*args):
            calls.append((name, symbol, len(argtypes), args))
            return 0
        return launch

    monkeypatch.setattr(kernels, "function", fake)
    monkeypatch.setattr(kernels, "ptr", lambda t: t)  # the fake sees the tensors themselves
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    h = torch.zeros((E, C, F), dtype=torch.bfloat16)
    assert mf_ops.down_combine_bwd_path(h.dtype, F, D, mf_ops._aligned(dy, h, wd)) == "tensor_cores"
    dh, dwd, dsw = mf_ops._launch_down_combine_bwd(dy, h, wd, plan.flat_idx, plan.slot_w)
    dx, dwg, dwu = mf_ops._launch_gather_swiglu_bwd(dh, x, plan.flat_idx, plan.flat_cidx, wg, wu)
    (n1, s1, a1, args1), (n2, s2, a2, args2) = calls
    assert (n1, s1, n2, s2) == ("moe_fused_bwd", "repro_down_combine_bwd_tc",
                                "moe_fused_bwd", "repro_gather_swiglu_bwd_tc")
    assert a1 == len(args1) == 18 and a2 == len(args2) == 19
    assert args1[-6:] == (T, E, C, D, F, 0) and args2[-7:] == (T, E, C, D, F, K, 0)
    units = E * -(-C // mf_ops.BWD_UNIT)
    # dy, h, wd, flat_idx, slot_w, units, the slots' dy row pairs, weighted row pairs, part, dh, dwd, dslot_w
    ins = (dy, h, wd, plan.flat_idx, plan.slot_w)
    assert all(a is b for a, b in zip(args1[:5], ins))
    words, rpairs, spairs, part = args1[5:9]
    assert (words.dtype, words.numel()) == (torch.int32, 2 * units + E + 1)
    assert words.numel() == mf_ops.bwd_units_words(E, C)
    assert (rpairs.dtype, rpairs.numel()) == (spairs.dtype, spairs.numel()) == (torch.bfloat16, 2 * E * C * D)
    assert (part.dtype, part.numel()) == (torch.float32, E * C * -(-F // mf_ops.BWD_TILE["tensor_cores"]))
    assert args1[9] is dh and args1[10] is dwd and args1[11] is dsw
    assert (dh.shape, dwd.shape, dsw.shape) == ((E, C, F), (E, F, D), (E * C,))
    assert (dh.dtype, dwd.dtype, dsw.dtype) == (torch.bfloat16, torch.bfloat16, torch.float32)
    # dh, x, flat_idx, flat_cidx, wg, wu, units, dg/du pairs, dxs, dx, dwg, dwu
    assert all(a is b for a, b in zip(args2[:6], (dh, x, plan.flat_idx, plan.flat_cidx, wg, wu)))
    words, dgu, dxs = args2[6:9]
    assert (words.dtype, words.numel()) == (torch.int32, 2 * units + E + 1)
    assert (dgu.dtype, dgu.numel()) == (torch.bfloat16, 4 * E * C * F)  # the bytes of an f32 dg and du
    assert (dxs.dtype, dxs.numel()) == (torch.float32, E * C * D)  # its first half also holds the slots' x rows
    assert args2[9] is dx and args2[10] is dwg and args2[11] is dwu
    assert dx.shape == (T, D) and dwg.shape == dwu.shape == (E, D, F)


# ---------------------------------------------------------------------------
# the precision design, emulated, against the JAX reference
# ---------------------------------------------------------------------------

def _split(v, lo):
    hi = v.to(torch.bfloat16).float()
    return hi, ((v - hi).to(torch.bfloat16).float() if lo else torch.zeros_like(v))


def _tc_down_bwd(dy, h, wd, idx, sw, lo_dy=True, lo_rows=True):
    """4_bwd with the tensor-core build's roundings: q = R_hi Wd^T + R_lo
    Wd^T; dh = bf16(w q); d slot_w = <h, q>; dWd = h^T (w R)_hi + h^T (w
    R)_lo, rounded to bf16."""
    C = idx.numel() // E
    occ = (idx < T).reshape(E, C, 1)
    R = torch.cat([dy, dy.new_zeros((1, D))])[idx.long()].reshape(E, C, D)
    w = torch.where(occ, sw.reshape(E, C, 1), 0.0)
    wdt = wd.float().transpose(1, 2)
    r_hi, r_lo = _split(R, lo_dy)
    q = torch.bmm(r_hi, wdt) + torch.bmm(r_lo, wdt)
    dsw = torch.where(occ[..., 0], (h.float() * q).sum(-1), 0.0).reshape(-1)
    ht = h.float().transpose(1, 2)
    w_hi, w_lo = _split(w * R, lo_rows)
    dwd = torch.bmm(ht, w_hi) + torch.bmm(ht, w_lo)
    return (w * q).to(torch.bfloat16), dwd.to(torch.bfloat16), dsw


def _tc_gather_bwd(dh, x, idx, cidx, wg, wu, lo=True):
    """3_bwd with the tensor-core build's roundings: g, u from bf16 operands;
    dg, du in f32 split into hi + lo; dWg = xs^T dg_hi + xs^T dg_lo (and
    dWu); dxs = (dg_hi Wg^T + dg_lo Wg^T) + (du_hi Wu^T + du_lo Wu^T) in f32;
    dx the sum of each token's kept rows in ascending j."""
    C = idx.numel() // E
    xs = torch.cat([x, x.new_zeros((1, D))])[idx.long()].reshape(E, C, D).float()
    g, u = torch.bmm(xs, wg.float()), torch.bmm(xs, wu.float())
    sg = torch.sigmoid(g)
    dv = torch.where((idx < T).reshape(E, C, 1), dh.float(), 0.0)
    dg, du = dv * u * (sg * (1.0 + g * (1.0 - sg))), dv * (g * sg)
    (g_hi, g_lo), (u_hi, u_lo) = _split(dg, lo), _split(du, lo)
    xt = xs.transpose(1, 2)
    dwg, dwu = torch.bmm(xt, g_hi) + torch.bmm(xt, g_lo), torch.bmm(xt, u_hi) + torch.bmm(xt, u_lo)
    wgt, wut = wg.float().transpose(1, 2), wu.float().transpose(1, 2)
    dxs = (torch.bmm(g_hi, wgt) + torch.bmm(g_lo, wgt)) + (torch.bmm(u_hi, wut) + torch.bmm(u_lo, wut))
    dxs = torch.cat([dxs.reshape(E * C, D), dxs.new_zeros((1, D))])
    dx = torch.zeros((T, D))
    for j in range(K):
        dx = dx + dxs[cidx.reshape(T, K)[:, j].long()]
    return dx.to(torch.bfloat16), dwg.to(torch.bfloat16), dwu.to(torch.bfloat16)


def _reference_grads(x, jp, wg, wu, wd, h, dy, dh):
    """jax.vjp of the reference's composition split at h: (dh, dWd, d
    combine_w) of combine(h Wd) at dy, and (dx, dWg, dWu) of silu(xs Wg)
    (xs Wu), xs = dispatch(x), at dh; numpy f32."""
    j = lambda t: jnp.asarray(t.float().numpy())

    def down(h_, wd_, cw):  # local_experts_fn's down projection, then combine
        return jcp.combine(jnp.einsum("ecf,efd->ecd", h_, wd_), jp._replace(combine_w=cw))

    def gate_up(x_, wg_, wu_):  # dispatch, then local_experts_fn's gate and up projections
        xs = jcp.dispatch(x_, jp)
        g = jnp.einsum("ecd,edf->ecf", xs, wg_)
        return jax.nn.silu(g) * jnp.einsum("ecd,edf->ecf", xs, wu_)

    _, vjp4 = jax.vjp(down, j(h), j(wd), jp.combine_w)
    _, vjp3 = jax.vjp(gate_up, j(x), j(wg), j(wu))
    return [np.array(a) for a in vjp4(j(dy))], [np.array(a) for a in vjp3(j(dh))]


def _misses(got, want) -> int:
    want = torch.from_numpy(want).to(torch.bfloat16).float()  # the reference rounded as the outputs are
    lim = 2.0 ** -7 * want.abs() + 1e-3 * want.pow(2).mean().sqrt()
    return int(((got.float() - want).abs() > lim).sum())


@pytest.fixture(scope="module")
def held():
    x, tp, jp, wg, wu, wd, dy = _inputs()
    idx, sw, cidx = tp.flat_idx, tp.slot_w, tp.flat_cidx
    C = idx.numel() // E
    xs = torch.cat([x, x.new_zeros((1, D))])[idx.long()].reshape(E, C, D).float()
    h = (torch.nn.functional.silu(torch.bmm(xs, wg.float())) * torch.bmm(xs, wu.float())).to(torch.bfloat16)
    dh = _tc_down_bwd(dy, h, wd, idx, sw)[0]
    ref4, ref3 = _reference_grads(x, jp, wg, wu, wd, h, dy, dh)
    # d combine_w of a kept assignment is d slot_w of its slot
    kept = (tp.flat_cidx < E * C).numpy()
    dcw = ref4[2].reshape(-1)[kept]
    return dict(x=x, tp=tp, wg=wg, wu=wu, wd=wd, dy=dy, h=h, dh=dh, ref4=ref4, ref3=ref3, kept=kept, dcw=dcw)


def _dsw_err(dsw, s) -> float:
    """|d slot_w - d combine_w| over the kept assignments, over 1e-4 of the scale."""
    got = dsw[s["tp"].flat_cidx.long()[torch.from_numpy(s["kept"])]].numpy()
    return float(np.abs(got - s["dcw"]).max()) / (1e-4 * max(1.0, float(np.abs(s["dcw"]).max())))


@pytest.mark.parametrize("lo_dy,lo_rows", [(True, True), (False, True), (True, False)])
def test_down_backward_tc_precision_against_the_reference(held, lo_dy, lo_rows):
    s = held
    tp = s["tp"]
    dh, dwd, dsw = _tc_down_bwd(s["dy"], s["h"], s["wd"], tp.flat_idx, tp.slot_w, lo_dy, lo_rows)
    miss_dh, miss_dwd = _misses(dh, s["ref4"][0]), _misses(dwd, s["ref4"][1])
    err = _dsw_err(dsw, s)
    print(f"lo halves: dy {lo_dy}, weighted rows {lo_rows}: dh misses {miss_dh} of {dh.numel()}, "
          f"dWd {miss_dwd} of {dwd.numel()}, d slot_w {err:.3f} of the 1e-4 gate")
    assert (miss_dh == 0 and err <= 1.0) == lo_dy  # R's lo half: dh and d slot_w need it
    assert (miss_dwd == 0) == lo_rows  # the weighted rows' lo half: dWd needs it


@pytest.mark.parametrize("lo", [True, False])
def test_gate_up_backward_tc_precision_against_the_reference(held, lo):
    s = held
    tp = s["tp"]
    got = _tc_gather_bwd(s["dh"], s["x"], tp.flat_idx, tp.flat_cidx, s["wg"], s["wu"], lo)
    miss = {n: _misses(g, w) for n, g, w in zip(("dx", "dWg", "dWu"), got, s["ref3"])}
    print(f"dg/du lo halves {lo}: misses {miss}")
    assert all((m == 0) == lo for m in miss.values())  # each output needs the lo halves
