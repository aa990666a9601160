"""PyTorch port, on the card: each CUDA kernel against its plain version.

Runs only where ``torch.cuda.is_available()``; elsewhere every test skips
(a CUDA kernel has no CPU mode).  Imports no jax, so it runs on a machine
with the card and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.control_plane import route_topk
from repro_torch.core.plans import TreePlan
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.moe_decode import ops as md_ops
from repro_torch.kernels.moe_decode import ref as md_ref
from repro_torch.kernels.moe_fused import ops as mf_ops
from repro_torch.kernels.moe_fused import ref as mf_ref


def _t(a):
    return torch.from_numpy(np.array(a))


def _decode_case(seed, B, T, nq, nkv, hd, S):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, nq, hd), (B, S, nkv, hd), (B, S, nkv, hd)))


def _moe_stacks(seed, E, d, f):
    rng = np.random.default_rng(seed)
    wg = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)
    return wg, wu, wd


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# kernel vs plain on the card: f32 sums in another order (and atomics in
# down_combine) -> 1e-4 relative to the output scale.  bf16 outputs are held
# elementwise: both sides compute in f32 and round once to bf16, so an
# element may differ by one bf16 ulp (at most 2^-7 of its value), plus a
# 1e-3 x rms floor for elements that cancel to near zero.


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.bfloat16:
        lim = 2.0 ** -7 * want.abs() + 1e-3 * want.pow(2).mean().sqrt()
        assert bool(((got - want).abs() <= lim).all())
    else:
        assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain_on_card(cuda, dtype):
    tree = TreePlan.from_branching((2, 1))
    B, T, nq, nkv, hd, S = 3, tree.num_nodes, 16, 4, 128, 200
    q, k, v = (_t(a).to(cuda, dtype) for a in _decode_case(1, B, T, nq, nkv, hd, S))
    base = torch.tensor([0, 77, 190], dtype=torch.int32, device=cuda)
    lengths = (base[:, None] + torch.arange(1, T + 1, device=cuda, dtype=torch.int32)).reshape(-1).contiguous()
    words = torch.tensor(tree.ancestor_words(), dtype=torch.int32, device=cuda)
    got = fa_ops.flash_decode_kernel(q, k, v, lengths, words, base)
    torch.cuda.synchronize()
    _close(got, fa_ref.flash_decode(q, k, v, lengths, words, base), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_moe_kernel_matches_plain_on_card(cuda, dtype):
    T, k, E, d, f = 5, 4, 16, 256, 192
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((T, d)).astype(np.float32)).to(cuda, dtype)
    ids = _t(np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)).to(cuda)
    w = _t(rng.random((T, k)).astype(np.float32)).to(cuda)
    wg, wu, wd = (_t(a).to(cuda, dtype) for a in _moe_stacks(2, E, d, f))
    got = md_ops.decode_moe_kernel(x, ids, w, wg, wu, wd)
    torch.cuda.synchronize()
    _close(got, md_ref.decode_moe(x, ids, w, wg, wu, wd), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_moe_kernels_match_plain_on_card(cuda, dtype):
    T, E, k, C, d, f = 40, 8, 2, 7, 96, 80
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((T, d)).astype(np.float32))
    plan, _ = route_topk(x, _t(rng.standard_normal((d, E)).astype(np.float32)), k, C)
    idx, sw = plan.flat_idx.to(cuda), plan.slot_w.to(cuda)
    xt = x.to(cuda, dtype)
    wg, wu, wd = (_t(a).to(cuda, dtype) for a in _moe_stacks(4, E, d, f))
    h = mf_ops.gather_swiglu(xt, idx, wg, wu)
    torch.cuda.synchronize()
    _close(h, mf_ref.gather_swiglu(xt, idx, wg, wu), dtype)
    y = mf_ops.down_combine(h, wd, idx, sw, T)
    torch.cuda.synchronize()
    _close(y, mf_ref.down_combine(h, wd, idx, sw, T), torch.float32)
