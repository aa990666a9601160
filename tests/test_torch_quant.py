"""PyTorch port, the quantized bandwidth plane's pieces on the CPU: the
quantizer, the int8 expert twins and their bridge, and the plain versions
of the four int8 kernel branches.

Gates, all bitwise (``torch.equal`` / ``assert_array_equal``, no
tolerance):
* ``quantize_int8``/``dequantize_int8`` equal the reference's on the same
  numpy inputs: ties at .5 (round half to even), all-zero blocks (scale 1),
  a bf16 input (the scale comes back bf16), a per-tensor scale;
* ``quantize_expert_stacks`` equals the reference's on the reference's
  stacks, the bridged ``*_q``/``*_s`` leaves equal the reference's own twins
  (int8 and f32, never re-quantized), and a rank's placement cuts the twins
  and their scales by expert as it cuts the stacks;
* each plain version with ``scales=`` equals itself on the dequantized f32
  buffer: flash-decode over a chain and a tree, paged through a scrambled
  table (trash row included), rolling across the wrap point, and the decode
  MoE over a sparse plan (T*k < E, the reference's gather regime) and a
  dense one (T*k >= E, its combine-matrix regime; the port's plain version
  has one form for both).
The card's int8 kernels against the same buffers are in
``tests/test_torch_cuda_kernels.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import get_smoke_config as j_smoke
from repro.core.quant import dequantize_int8 as j_dequantize
from repro.core.quant import quantize_int8 as j_quantize
from repro.models.model import Model as JModel
from repro.models.moe import quantize_expert_stacks as j_quantize_stacks
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.plans import TreePlan
from repro_torch.core.quant import dequantize_int8, quantize_int8
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.moe_decode import ref as md_ref
from repro_torch.launch.mesh import Mesh
from repro_torch.models.layers import storage_dtype
from repro_torch.models.moe import quantize_expert_stacks
from repro_torch.parallel.sharding import shard_params

ARCH = "qwen3-moe-235b-a22b"
STACKS = ("w_gate", "w_up", "w_down")


def _ties_input():
    """Rows whose amax is 127 (scale 1.0), so x / scale lands exactly on
    .5 ties; one all-zero block; the rest random."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 0, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[1, 0, 1] = [3.5, -3.5, 4.5, -4.5, 0.0, 0.0, 0.0, 0.0]
    return x


QUANT_CASES = {
    "ties_rows": (np.float32, (-2, -1)),
    "ties_per_tensor": (np.float32, None),
    "bf16_rows": ("bfloat16", (-2, -1)),
    "expert_axes": (np.float32, (1, 2)),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_int8_matches_reference_bitwise(case):
    dtype, axis = QUANT_CASES[case]
    x = _ties_input()
    if dtype == "bfloat16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(np.asarray(jx.astype(jnp.float32)), tx.float().numpy())
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = j_quantize(jx, axis=axis)
    tq, ts = quantize_int8(tx, axis=axis)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert str(ts.dtype).split(".")[-1] == str(js.dtype)  # bf16 in, bf16 scale out
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js.astype(jnp.float32)))
    np.testing.assert_array_equal(dequantize_int8(tq, ts).float().numpy(),
                                  np.asarray(j_dequantize(jq, js).astype(jnp.float32)))
    if axis == (-2, -1):
        assert float(ts.float()[0, 0].reshape(-1)[0]) == 1.0  # the all-zero block keeps scale 1
        got = tq[1, 0].reshape(-1)[:12].tolist()
        assert got == [127, 0, 2, 2, 0, -2, -2, 126, 4, -4, 4, -4]  # half to even


def test_dequantize_int8_dtype_override():
    q, s = quantize_int8(torch.from_numpy(_ties_input()), axis=(-2, -1))
    jq, js = j_quantize(jnp.asarray(_ties_input()), axis=(-2, -1))
    got = dequantize_int8(q, s, dtype=torch.bfloat16)
    want = j_dequantize(jq, js, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _reference_int8_params(**kw):
    cfg = dataclasses.replace(j_smoke(ARCH), decode_plane=True, expert_dtype="int8", **kw)
    params = JModel(cfg).init(jax.random.PRNGKey(0))
    names, leaves, _ = _flatten(params)
    return cfg, {n: np.asarray(v) for n, v in zip(names, leaves)}


def test_quantize_expert_stacks_matches_reference_bitwise():
    _, arrays = _reference_int8_params()
    for layer in (0, 1):
        jp = {n: jnp.asarray(arrays[f"blocks/scan/b0/moe/{n}"][layer]) for n in STACKS}
        tp = {n: torch.from_numpy(np.array(arrays[f"blocks/scan/b0/moe/{n}"][layer])) for n in STACKS}
        want, got = j_quantize_stacks(jp), quantize_expert_stacks(tp)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == (torch.int8 if name.endswith("_q") else torch.float32)
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


def test_bridged_twins_are_the_references_bitwise():
    jcfg, arrays = _reference_int8_params()
    tcfg = dataclasses.replace(t_smoke(ARCH), decode_plane=True, expert_dtype="int8")
    assert storage_dtype(tcfg, "w_gate_q") == torch.int8 and storage_dtype(tcfg, "w_up_s") == torch.float32
    params = params_from_numpy(tcfg, arrays, "cpu")
    n_sb = jcfg.num_layers
    for i in range(n_sb):
        moe = params["layers"][i]["moe"]
        for name in STACKS:
            for suffix, dt in (("_q", torch.int8), ("_s", torch.float32)):
                leaf = moe[name + suffix]
                assert leaf.dtype == dt
                np.testing.assert_array_equal(leaf.numpy(), arrays[f"blocks/scan/b0/moe/{name}{suffix}"][i])
    # the port's own init draws the same twins from its own stacks
    own = quantize_expert_stacks(params["layers"][0]["moe"])
    for name, leaf in own.items():
        assert torch.equal(leaf, params["layers"][0]["moe"][name]), name


@pytest.mark.parametrize("ep", [2, 4])
def test_rank_placement_cuts_twins_and_scales_by_expert(ep):
    cfg = dataclasses.replace(t_smoke(ARCH), decode_plane=True, expert_dtype="int8", num_experts=8)
    from repro_torch.models.model import Model

    full = Model(cfg, device="cpu").init(0)
    _, arrays = _reference_int8_params(num_experts=8)
    e_loc = cfg.num_experts // ep
    for r in range(ep):
        mesh = Mesh({"data": 1, "model": ep}, {"data": 0, "model": r}, {}, torch.device("cpu"))
        placed = shard_params(full, cfg, mesh)["layers"][0]["moe"]
        drawn = Model(cfg, device="cpu", experts=slice(r * e_loc, (r + 1) * e_loc)).init(0)["layers"][0]["moe"]
        bridged = params_from_numpy(cfg, arrays, "cpu", mesh)["layers"][0]["moe"]
        for name in STACKS:
            for leaf in (name, name + "_q", name + "_s"):
                want = full["layers"][0]["moe"][leaf][r * e_loc:(r + 1) * e_loc]
                assert torch.equal(placed[leaf], want), leaf
                assert torch.equal(drawn[leaf], want), leaf
                assert bridged[leaf].shape[0] == e_loc, leaf
            np.testing.assert_array_equal(bridged[name + "_q"].numpy(),
                                          arrays[f"blocks/scan/b0/moe/{name}_q"][0][r * e_loc:(r + 1) * e_loc])


# ---------------------------------------------------------------------------
# plain versions with scales == themselves on the dequantized buffer
# ---------------------------------------------------------------------------


def _int8_rows(rng, shape):
    """An int8 cache buffer (..., nkv, hd) and its per-row f32 scales."""
    q, s = quantize_int8(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), axis=(-2, -1))
    return q, s[..., 0, 0]


def _deq(c, s):
    return c.float() * s[..., None, None]


@pytest.mark.parametrize("words", ["chain", "tree"])
def test_plain_flash_decode_int8_is_itself_on_the_dequantized_cache(words):
    rng = np.random.default_rng(5)
    B, nq, nkv, hd, S = 2, 4, 2, 16, 24
    tree = TreePlan.chain(4) if words == "chain" else TreePlan.from_branching((2, 1))
    T = tree.num_nodes
    q = torch.from_numpy(rng.standard_normal((B, T, nq, hd)).astype(np.float32))
    (k, ks), (v, vs) = _int8_rows(rng, (B, S, nkv, hd)), _int8_rows(rng, (B, S, nkv, hd))
    base = torch.tensor([5, 17], dtype=torch.int32)
    lengths = (base[:, None] + torch.arange(1, T + 1, dtype=torch.int32)).reshape(-1)
    anc = torch.tensor(tree.ancestor_words(), dtype=torch.int32)
    scales = torch.stack([ks, vs]).reshape(2, -1)
    got = fa_ref.flash_decode(q, k, v, lengths, anc, base, scales)
    want = fa_ref.flash_decode(q, _deq(k, ks), _deq(v, vs), lengths, anc, base)
    assert torch.equal(got, want)
    # the wrapper takes the plain version on CPU tensors, and the same layout
    assert torch.equal(fa_ops.flash_decode_kernel(q, k, v, lengths, anc, base, scales), want)
    qb = q.to(torch.bfloat16)
    assert torch.equal(fa_ref.flash_decode(qb, k, v, lengths, anc, base, scales),
                       fa_ref.flash_decode(qb.float(), _deq(k, ks), _deq(v, vs), lengths, anc, base).to(torch.bfloat16))


def test_plain_flash_decode_paged_int8_is_itself_on_the_dequantized_pool():
    rng = np.random.default_rng(6)
    B, nq, nkv, hd, ps, P = 2, 4, 2, 16, 4, 8
    tree = TreePlan.from_branching((2, 1))
    T = tree.num_nodes
    q = torch.from_numpy(rng.standard_normal((B, T, nq, hd)).astype(np.float32))
    R = P * ps + 1  # the pool's trash row included, as the model keeps it
    (pk, pks), (pv, pvs) = _int8_rows(rng, (R, nkv, hd)), _int8_rows(rng, (R, nkv, hd))
    table = torch.tensor([[5, 2, 7, -1], [0, 6, 3, 1]], dtype=torch.int32).reshape(-1)
    base = torch.tensor([7, 9], dtype=torch.int32)
    lengths = (base[:, None] + torch.arange(1, T + 1, dtype=torch.int32)).reshape(-1)
    anc = torch.tensor(tree.ancestor_words(), dtype=torch.int32)
    scales = torch.stack([pks, pvs])
    got = fa_ops.flash_decode_paged_kernel(q, pk, pv, lengths, table, anc, base, scales, page_size=ps)
    want = fa_ref.flash_decode_paged(q, _deq(pk, pks), _deq(pv, pvs), lengths, table, anc, base, ps)
    assert torch.equal(got, want)


def test_plain_flash_decode_window_int8_crosses_the_wrap():
    rng = np.random.default_rng(7)
    B, T, nq, nkv, hd, W = 2, 3, 4, 1, 16, 8
    q = torch.from_numpy(rng.standard_normal((B, T, nq, hd)).astype(np.float32))
    (k, ks), (v, vs) = _int8_rows(rng, (B, W, nkv, hd)), _int8_rows(rng, (B, W, nkv, hd))
    start = torch.tensor([6, 13])  # both launches straddle slot W - 1 -> 0
    got = fa_ops.flash_decode_window(q, k, v, start, window=6, scales=torch.stack([ks, vs]))
    want = fa_ops.flash_decode_window(q, _deq(k, ks), _deq(v, vs), start, window=6)
    assert torch.equal(got, want)


@pytest.mark.parametrize("regime", ["sparse_plan", "dense_plan"])
def test_plain_decode_moe_int8_is_itself_on_the_dequantized_stacks(regime):
    rng = np.random.default_rng(8)
    E, d, f = (16, 24, 20) if regime == "sparse_plan" else (4, 24, 20)
    Tn, k = 3, 2  # T*k = 6: < 16 (sparse), >= 4 (dense)
    x = torch.from_numpy(rng.standard_normal((Tn, d)).astype(np.float32))
    ids = torch.from_numpy(np.stack([rng.choice(E, k, replace=False) for _ in range(Tn)]).astype(np.int32))
    w = torch.from_numpy(rng.random((Tn, k)).astype(np.float32))
    stacks, scales = [], []
    for shape in ((E, d, f), (E, d, f), (E, f, d)):
        qt, s = quantize_int8(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), axis=(1, 2))
        stacks.append(qt)
        scales.append(s[:, 0, 0])
    scl = torch.stack(scales)
    got = md_ref.decode_moe(x, ids, w, *stacks, scales=scl)
    deq = [dequantize_int8(st, sc[:, None, None]) for st, sc in zip(stacks, scl)]
    assert torch.equal(got, md_ref.decode_moe(x, ids, w, *deq))
    xb = x.to(torch.bfloat16)
    assert torch.equal(md_ref.decode_moe(xb, ids, w, *stacks, scales=scl), md_ref.decode_moe(xb.float(), ids, w, *deq))
