"""PyTorch port, on the CPU: the grouping and combine order of kernel 2, and
kernel 4's build choice.

Kernel 2 (``decode_moe_kernel``, ``csrc/moe_decode.cu``) groups the plan's
assignments by expert on the card: the block of assignment ``a`` leads a
group when the number of earlier assignments naming its expert is a
multiple of ``GROUP``, and serves that many of them from ``a`` on, in
ascending order, reading the expert's weights once for all of them; the
weighted rows ``w_a * y_a`` are then summed per token in ascending ``j``.
That logic lives in CUDA, which cannot run here, so this file writes it out
in plain torch (:func:`_groups`, :func:`_grouped_decode_moe`) and holds the
model against the JAX package's ``decode_moe`` on its jnp path
(``decode_moe_pallas`` cannot run in interpret mode on this jax, ROADMAP
Queue C R1): random plans, repeated ids, a ``shard_slice`` remap that sends
more than ``GROUP`` assignments to local expert 0, T = 1, f32 and int8
stacks.  The int8 branch's conversion of a code without the int-to-float
unit is checked bit for bit over all 256 codes.  The kernel itself is held
on the card (``tests/test_torch_cuda_kernels.py``, ``-m cuda``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plans import DecodePlan as JDecodePlan
from repro.kernels.moe_decode import ref as j_ref
from repro_torch.core.plans import DecodePlan
from repro_torch.kernels.moe_fused import ops as mf_ops

# assignments one block of kernel 2 serves at most (csrc/moe_decode.cu, GROUP)
GROUP = 8

_j_decode_moe = jax.jit(j_ref.decode_moe)


def _groups(ids: torch.Tensor, group: int = GROUP):
    """Kernel 2's groups of the flat (T*k,) plan, one per leading block, in
    the order of the leaders: (expert, ascending assignment indices)."""
    flat = ids.reshape(-1).tolist()
    out = []
    for a, e in enumerate(flat):
        rank = sum(1 for i in range(a) if flat[i] == e)
        if rank % group == 0:
            out.append((e, [i for i in range(a, len(flat)) if flat[i] == e][:group]))
    return out


def _grouped_decode_moe(x, ids, w, wg, wu, wd, scales=None):
    """Kernel 2's dataflow in plain torch, f32: per group, the expert's
    stacks read once (dequantized as the int8 branch reads them: code times
    scale, rounded once) for its assignments' rows; the weighted rows
    ``w_a * y_a`` into a (T*k, d) scratch; each token's k rows summed in
    ascending j."""
    T, k = ids.shape
    xf, wf = x.float(), w.reshape(-1).float()
    rows = torch.full((T * k, x.shape[1]), float("nan"))
    for e, members in _groups(ids):
        g_, u_, d_ = (s[e].float() for s in (wg, wu, wd))
        if scales is not None:
            g_, u_, d_ = (m * scales[i][e] for i, m in enumerate((g_, u_, d_)))
        idx = torch.tensor(members)
        h = torch.nn.functional.silu(xf[idx // k] @ g_) * (xf[idx // k] @ u_)
        rows[idx] = wf[idx, None] * (h @ d_)
    out = torch.zeros((T, x.shape[1]))
    for j in range(k):
        out = out + rows[j::k]
    return out


def _case(seed, T, k, E, d, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    wg, wu = ((rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32) for _ in range(2))
    wd = (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, ids, w, wg, wu, wd


def _check_partition(ids: torch.Tensor):
    """Every assignment in exactly one group; a group names one expert, in
    ascending order, at most GROUP long; an expert named n times is read
    ceil(n / GROUP) times."""
    flat = ids.reshape(-1).tolist()
    groups = _groups(ids)
    seen = sorted(i for _, m in groups for i in m)
    assert seen == list(range(len(flat)))
    for e, m in groups:
        assert m == sorted(m) and 1 <= len(m) <= GROUP and all(flat[i] == e for i in m)
    for e in set(flat):
        assert sum(1 for g, _ in groups if g == e) == -(-flat.count(e) // GROUP)
    return groups


def _plans():
    """(name, T, k, E, ids or None): random top-k plans (top-1 too), T = 1,
    one expert named by every assignment, and shard slices of a top-8 plan over 32
    experts held by 2 shards of 16 (local expert 0 named by the foreign
    assignments: more than GROUP of them, at weight 0)."""
    rng = np.random.default_rng(5)
    full = np.stack([rng.permutation(32)[:8] for _ in range(16)]).astype(np.int32)
    # top-1 (Llama-4's routing): 16 tokens over 128 experts (mostly groups of
    # one), over 8 (groups of up to 8 and more than one group an expert),
    # and one expert named by all 20
    return [("random", 16, 8, 32, None), ("T=1", 1, 8, 32, None), ("random k=2", 9, 2, 8, None),
            ("all ids equal", 6, 4, 8, np.zeros((6, 4), np.int32)),
            ("shard 0 of 2", 16, 8, 16, full), ("shard 1 of 2", 16, 8, 16, full),
            ("top-1 of 128", 16, 1, 128, None), ("top-1 of 8", 40, 1, 8, None),
            ("top-1 all ids equal", 20, 1, 8, np.zeros((20, 1), np.int32))]


@pytest.mark.parametrize("name,T,k,E,ids", _plans(), ids=[p[0] for p in _plans()])
def test_grouping_model_matches_jax_decode_moe(name, T, k, E, ids):
    """The model within 1e-5 of the JAX reference (both f32; sums in other
    orders), the partition rule on its plan, and for a shard slice the same
    remap in both packages."""
    d, f = 48, 40
    x, rids, w, wg, wu, wd = _case(len(name), T, k, E if ids is None else 32, d, f)
    if ids is not None:
        rids = ids
    if name.startswith("shard"):
        first = 0 if name == "shard 0 of 2" else 16
        jplan = JDecodePlan(jnp.asarray(rids), jnp.asarray(w)).shard_slice(first, 16)
        plan = DecodePlan(torch.from_numpy(rids), torch.from_numpy(w)).shard_slice(first, 16)
        assert np.array_equal(plan.expert_ids.numpy(), np.asarray(jplan.expert_ids))
        assert np.array_equal(plan.weights.numpy(), np.asarray(jplan.weights))
        assert int((plan.expert_ids == 0).sum()) > GROUP
        rids, w = plan.expert_ids.numpy(), plan.weights.numpy()
        wg, wu, wd = (a[first:first + 16] for a in (wg, wu, wd))
    ids_t = torch.from_numpy(rids)
    _check_partition(ids_t)
    got = _grouped_decode_moe(torch.from_numpy(x), ids_t, torch.from_numpy(w),
                              *(torch.from_numpy(a) for a in (wg, wu, wd)))
    want = np.asarray(_j_decode_moe(*(jnp.asarray(a) for a in (x, rids, w, wg, wu, wd))))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T,k,E", [(16, 8, 32), (1, 8, 32)])
def test_grouping_model_int8_matches_jax_decode_moe(T, k, E):
    """int8 stacks with (3, E) scales: the model, dequantizing as the int8
    branch does, within 1e-5 of the JAX reference's int8 path."""
    from repro_torch.core.quant import quantize_int8

    x, ids, w, wg, wu, wd = _case(T + 100, T, k, E, 48, 40)
    twins = [quantize_int8(torch.from_numpy(a), axis=(1, 2)) for a in (wg, wu, wd)]
    stacks = [q for q, _ in twins]
    scales = torch.stack([s[:, 0, 0] for _, s in twins])
    got = _grouped_decode_moe(torch.from_numpy(x), torch.from_numpy(ids), torch.from_numpy(w), *stacks, scales)
    want = np.asarray(_j_decode_moe(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(w),
                                    *(jnp.asarray(q.numpy()) for q in stacks), jnp.asarray(scales.numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_int8_code_conversion_is_exact():
    """The int8 branch's conversion: code c ^ 0x80 in the low byte of
    0x4B400000 (1.5 * 2^23) read as a float, minus 12,582,912 + 128, is c
    exactly for all 256 codes; and __fmul_rn(c, s) is the f32 product
    q.float() * s the dequantized stacks hold."""
    codes = np.arange(-128, 128, dtype=np.int32)
    bits = (np.uint32(0x4B400000) | ((codes.astype(np.uint32) ^ np.uint32(0x80)) & np.uint32(0xFF))).astype(np.uint32)
    vals = bits.view(np.float32) - np.float32(12583040.0)
    assert vals.dtype == np.float32 and np.array_equal(vals, codes.astype(np.float32))
    s = np.float32(0.0123456)
    assert np.array_equal((vals * s).astype(np.float32),
                          (torch.from_numpy(codes.astype(np.int8)).float() * float(s)).numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_down_combine_path_is_tensor_cores_exactly_for_bf16_with_16_byte_strides(dtype):
    """Kernel 4 takes the tensor cores for bf16 with f and d multiples of 8
    and aligned bases (the admission shape), the CUDA cores otherwise (f 84,
    d 100, an unaligned base, f32)."""
    bf = dtype == torch.bfloat16
    assert mf_ops.down_combine_path(dtype, 1536, 4096, True) == ("tensor_cores" if bf else "cuda_cores")
    assert mf_ops.down_combine_path(dtype, 80, 96, True) == ("tensor_cores" if bf else "cuda_cores")
    assert mf_ops.down_combine_path(dtype, 84, 96, True) == "cuda_cores"
    assert mf_ops.down_combine_path(dtype, 80, 100, True) == "cuda_cores"
    assert mf_ops.down_combine_path(dtype, 1536, 4096, False) == "cuda_cores"
    assert mf_ops.down_combine_path(dtype, 0, 4096, True) == "cuda_cores"
