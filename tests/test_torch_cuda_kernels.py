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
@pytest.mark.parametrize("ps", [8, 16])
def test_flash_decode_paged_kernel_matches_plain_on_card(cuda, dtype, ps):
    """A scrambled block table with -1 past each sequence's clamp, tree
    words; then the identity table against the contiguous kernel, bitwise."""
    tree = TreePlan.from_branching((2, 1))
    B, T, nq, nkv, hd, mp = 3, tree.num_nodes, 16, 4, 128, 13
    S = mp * ps
    q, k, v = (_t(a).to(cuda, dtype) for a in _decode_case(2, B, T, nq, nkv, hd, S))
    base = torch.tensor([0, 37, S - T], dtype=torch.int32, device=cuda)
    lengths = (base[:, None] + torch.arange(1, T + 1, device=cuda, dtype=torch.int32)).reshape(-1).contiguous()
    words = torch.tensor(tree.ancestor_words(), dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(ps)
    table = rng.permutation(B * mp).reshape(B, mp).astype(np.int32)
    for b, L in enumerate((base + T).tolist()):
        table[b, (L - 1) // ps + 1:] = -1
    table = _t(table).reshape(-1).to(cuda)
    pk, pv = k.reshape(B * S, nkv, hd), v.reshape(B * S, nkv, hd)
    got = fa_ops.flash_decode_paged_kernel(q, pk, pv, lengths, table, words, base, page_size=ps)
    torch.cuda.synchronize()
    _close(got, fa_ref.flash_decode_paged(q, pk, pv, lengths, table, words, base, ps), dtype)
    ident = torch.arange(B * mp, dtype=torch.int32, device=cuda)
    for w, bs in ((words, base), (None, None)):
        paged = fa_ops.flash_decode_paged_kernel(q, pk, pv, lengths, ident, w, bs, page_size=ps)
        assert torch.equal(paged, fa_ops.flash_decode_kernel(q, k, v, lengths, w, bs))


def _decode_inputs(cuda, policy, kv, T, S, nq=16, nkv=4, hd=128, B=2, ps=16, seed=0):
    """q and the K/V of a kernel-1 (contiguous) or kernel-5 (paged, through
    a scrambled block table) launch, in ``kv``'s type (int8 with scales
    beside a bf16 q), and a runner ``run(lengths, words, base)``
    with its plain version ``plain(lengths, words, base)``."""
    from repro_torch.core.quant import quantize_int8

    q, k, v = _decode_case(seed, B, T, nq, nkv, hd, S)
    q = _t(q).to(cuda, torch.bfloat16 if kv == "int8" else kv)
    k, v = _t(k).to(cuda), _t(v).to(cuda)
    scales = None
    if kv == "int8":
        (k, ks), (v, vs) = (quantize_int8(c, axis=(-2, -1)) for c in (k, v))
        scales = torch.stack([ks[..., 0, 0], vs[..., 0, 0]]).reshape(2, -1).contiguous()
    else:
        k, v = k.to(kv), v.to(kv)
    if policy == "contiguous":
        def run(lengths, words, base, qq=q):
            return fa_ops.flash_decode_kernel(qq, k, v, lengths, words, base, scales)

        def plain(lengths, words, base, qq=q):
            return fa_ref.flash_decode(qq, k, v, lengths, words, base, scales)
        return q, run, plain
    table = _t(np.random.default_rng(seed).permutation(B * S // ps).astype(np.int32)).to(cuda)
    pk, pv = k.reshape(B * S, nkv, hd), v.reshape(B * S, nkv, hd)

    def run(lengths, words, base, qq=q):
        return fa_ops.flash_decode_paged_kernel(qq, pk, pv, lengths, table, words, base, scales, page_size=ps)

    def plain(lengths, words, base, qq=q):
        return fa_ref.flash_decode_paged(qq, pk, pv, lengths, table, words, base, ps, scales)
    return q, run, plain


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16, "int8"])
@pytest.mark.parametrize("policy", ["contiguous", "paged"])
@pytest.mark.parametrize("words", ["chain", "tree"])
@pytest.mark.parametrize("S", [240, 2240])
def test_flash_decode_split_edges_on_card(cuda, kv, policy, words, S):
    """Kernels 1 and 5 split each token's run over chunks of
    ``DECODE_CHUNK`` rows of the row capacity S (240: 4 chunks, a split
    each; 2,240: 35 chunks over the 32 splits of the cap, two a split):
    runs of 1, 63, 64, 65, 128, 212 and S rows (the last token's) and
    S + 1 minus those, chain words or tree 2,1's, against the plain version
    and bitwise on a repeated launch."""
    T = 4
    q, run, plain = _decode_inputs(cuda, policy, kv, T, S)
    anc = None if words == "chain" else torch.tensor(TreePlan.from_branching((2, 1)).ancestor_words(),
                                                     dtype=torch.int32, device=cuda)
    full = torch.full((T,), -1, dtype=torch.int32, device=cuda)
    for L in (1, 63, 64, 65, 128, 212, S):
        # slot 0's last token sees L rows, slot 1's S + 1 - L; base just below
        lengths = torch.tensor([[max(1, n - T + 1 + t) for t in range(T)] for n in (L, S + 1 - L)],
                               dtype=torch.int32, device=cuda).reshape(-1)
        base = (lengths.reshape(2, T)[:, 0] - 1).contiguous()
        got = run(lengths, anc, base)
        assert torch.equal(got, run(lengths, anc, base)), L
        torch.cuda.synchronize()
        _close(got, plain(lengths, full if anc is None else anc, base), q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16, "int8"])
@pytest.mark.parametrize("policy", ["contiguous", "paged"])
def test_flash_decode_tokens_launched_alone_are_bitwise_on_card(cuda, kv, policy):
    """A T-token launch (tree 2,1) is bitwise the same T tokens launched one
    at a time: a token's sums depend on its own run and S alone."""
    tree = TreePlan.from_branching((2, 1))
    T, S = tree.num_nodes, 240
    q, run, _ = _decode_inputs(cuda, policy, kv, T, S, seed=5)
    base = torch.tensor([61, 190], dtype=torch.int32, device=cuda)
    lengths = (base[:, None] + torch.arange(1, T + 1, dtype=torch.int32, device=cuda)).reshape(-1).contiguous()
    words = torch.tensor(tree.ancestor_words(), dtype=torch.int32, device=cuda)
    together = run(lengths, words, base)
    for t in range(T):
        alone = run(lengths.reshape(2, T)[:, t].contiguous(), words[t:t + 1].contiguous(), base,
                    qq=q[:, t:t + 1].contiguous())
        assert torch.equal(alone[:, 0], together[:, t]), t


@pytest.mark.cuda
def test_flash_decode_many_slots_above_the_split_cap_on_card(cuda):
    """2,100 slots over a 2,112-row capacity: 32 splits a slot, 67,200
    (slot, split) blocks along the grid's x.  Each slot's output is bitwise
    the same slot launched with three others, and the first four match the
    plain version."""
    B, T, nq, nkv, hd, S = 2100, 1, 16, 1, 128, 2112
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((B, T, nq, hd), generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((B, S, nkv, hd), generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    lengths = torch.randint(1, S + 1, (B * T,), generator=g, device=cuda, dtype=torch.int32)
    got = fa_ops.flash_decode_kernel(q, k, v, lengths)
    for lo in (0, 1000, B - 4):
        sl = slice(lo, lo + 4)
        few = fa_ops.flash_decode_kernel(q[sl].contiguous(), k[sl].contiguous(), v[sl].contiguous(),
                                         lengths[sl].contiguous())
        assert torch.equal(few, got[sl]), lo
    chain = torch.full((T,), -1, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    _close(got[:4], fa_ref.flash_decode(q[:4], k[:4], v[:4], lengths[:4], chain,
                                        torch.zeros((4,), dtype=torch.int32, device=cuda)), torch.bfloat16)


# kernel 2's plans: (T, k, E, d, f, ids or None for a random top-k plan).
# "shard slice": a top-8 plan over 32 experts as shard 1 of 2 sees it, local
# expert 0 named by every foreign assignment (more than 16, at weight 0);
# "all ids equal": one expert named 24 times (three groups of 8); "top-1":
# Llama-4's routing (k = 1) at small widths, and at its widths (d 5120, f
# 8192) over 16 experts
def _decode_moe_plan(case, rng):
    T, k, E, d, f = {"small": (5, 4, 16, 256, 192), "serving": (16, 8, 128, 4096, 1536),
                     "ragged": (5, 4, 16, 100, 84), "T=1": (1, 8, 128, 4096, 1536),
                     "all ids equal": (6, 4, 16, 256, 192), "shard slice": (16, 8, 16, 512, 256),
                     "top-1": (9, 1, 32, 256, 192), "top-1 wide": (16, 1, 16, 5120, 8192)}[case]
    if case == "all ids equal":
        ids = np.zeros((T, k), np.int32)
    elif case == "shard slice":
        full = np.stack([rng.permutation(2 * E)[:k] for _ in range(T)]).astype(np.int32)
        ids = np.where(full >= E, full - E, 0).astype(np.int32)
    else:
        ids = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    w = rng.random((T, k)).astype(np.float32)
    if case == "shard slice":
        w = np.where(full >= E, w, 0).astype(np.float32)
        assert int((ids == 0).sum()) > 16 and float(w[(ids == 0) & (full < E)].max()) == 0.0
    return T, k, E, d, f, ids, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("case", ["small", "serving", "ragged", "T=1", "all ids equal", "shard slice", "top-1",
                                  "top-1 wide"])
def test_decode_moe_kernel_matches_plain_on_card(cuda, dtype, case):
    """Kernel 2 (int8: the int8 branch with bf16 x) against its plain
    version within 1e-4 of the output scale, and bitwise on a repeated
    launch: at the serving shape (16 tokens, top-8 of 128, d 4096, f 1536),
    at d 100 and f 84 (rows not whole 16-byte pieces: element copies), at
    T = 1, with every id equal, and on a shard-sliced plan."""
    rng = np.random.default_rng(len(case))
    T, k, E, d, f, ids, w = _decode_moe_plan(case, rng)
    x = _t(rng.standard_normal((T, d)).astype(np.float32)).to(cuda, torch.float32 if dtype == torch.float32
                                                              else torch.bfloat16)
    ids, w = _t(ids).to(cuda), _t(w).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(len(case))
    stacks = [torch.randn(s, generator=g, device=cuda) * a for s, a in
              (((E, d, f), d ** -0.5), ((E, d, f), d ** -0.5), ((E, f, d), f ** -0.5))]
    if dtype == torch.int8:
        from repro_torch.core.quant import quantize_int8

        twins = [quantize_int8(s, axis=(1, 2)) for s in stacks]
        stacks, scales = [q for q, _ in twins], torch.stack([s[:, 0, 0] for _, s in twins]).contiguous()
    else:
        stacks, scales = [s.to(dtype) for s in stacks], None
    got = md_ops.decode_moe_kernel(x, ids, w, *stacks, scales)
    assert torch.equal(got, md_ops.decode_moe_kernel(x, ids, w, *stacks, scales))
    torch.cuda.synchronize()
    _close(got, md_ref.decode_moe(x, ids, w, *stacks, scales), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,f", [(7, 80), (8, 80), (12, 80), (16, 80), (40, 80), (100, 80), (16, 84)])
def test_fused_moe_kernels_match_plain_on_card(cuda, dtype, C, f):
    """Kernel 3 within one bf16 ulp (f32: 1e-4), bitwise on a repeated
    launch, then kernel 4 on its output.  bf16 takes both kernels'
    tensor-core builds at f 80 (a ragged 128-column tile) with slot tiles of
    16 (C <= 16) and 64 (C 40; C 100 over two tiles), and the CUDA-core
    builds at f 84 (not a whole number of 16-byte pieces); expert 0 is never
    routed to, so all its slots are empty (index T), and C 7 drops
    assignments."""
    T, E, k, d = 40, 8, 2, 96
    rng = np.random.default_rng(1)
    xn = rng.standard_normal((T, d)).astype(np.float32)
    router = rng.standard_normal((d, E)).astype(np.float32)
    xn[:, 0], router[0] = 10.0, 0.0
    router[0, 0] = -100.0  # every token's logit for expert 0 is ~-1,000: no token picks it
    x = _t(xn)
    plan, _ = route_topk(x, _t(router), k, C)
    assert bool((plan.flat_idx.reshape(E, C)[0] == T).all())
    idx, sw = plan.flat_idx.to(cuda), plan.slot_w.to(cuda)
    xt = x.to(cuda, dtype)
    wg, wu, wd = (_t(a).to(cuda, dtype) for a in _moe_stacks(4, E, d, f))
    want_path = "tensor_cores" if dtype == torch.bfloat16 and f % 8 == 0 else "cuda_cores"
    assert mf_ops.gather_swiglu_path(dtype, d, f, True) == want_path
    h = mf_ops.gather_swiglu(xt, idx, wg, wu)
    torch.cuda.synchronize()
    _close(h, mf_ref.gather_swiglu(xt, idx, wg, wu), dtype)
    assert torch.equal(h, mf_ops.gather_swiglu(xt, idx, wg, wu))
    assert mf_ops.down_combine_path(dtype, f, d, True) == want_path
    y = mf_ops.down_combine(h, wd, idx, sw, T)
    torch.cuda.synchronize()
    _close(y, mf_ref.down_combine(h, wd, idx, sw, T), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 16, 17, 64])
def test_down_combine_tensor_core_build_on_card(cuda, C):
    """Kernel 4's tensor-core build (bf16, f 80 and d 104: multiples of 8,
    not of 64 or 128, so TMA zero-fills the ragged K and N edges) at slot
    tiles of 16 (C 1, 16) and 64 (C 17, 64), expert 0 never routed to (an
    all-empty expert), empty slots past each expert's load (C 64) and
    dropped assignments (C 1): within 1e-4 of the plain version's output
    scale, bitwise on a repeated launch."""
    T, E, k, d, f = 40, 8, 2, 104, 80
    rng = np.random.default_rng(C)
    xn = rng.standard_normal((T, d)).astype(np.float32)
    router = rng.standard_normal((d, E)).astype(np.float32)
    xn[:, 0], router[0] = 10.0, 0.0
    router[0, 0] = -100.0  # no token picks expert 0
    plan, _ = route_topk(_t(xn), _t(router), k, C)
    assert bool((plan.flat_idx.reshape(E, C)[0] == T).all())
    idx, sw = plan.flat_idx.to(cuda), plan.slot_w.to(cuda)
    h = _t(rng.standard_normal((E, C, f)).astype(np.float32)).to(cuda, torch.bfloat16)
    wd = _t((rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)).to(cuda, torch.bfloat16)
    assert mf_ops.down_combine_path(torch.bfloat16, f, d, True) == "tensor_cores"
    y = mf_ops.down_combine(h, wd, idx, sw, T)
    assert torch.equal(y, mf_ops.down_combine(h, wd, idx, sw, T))
    torch.cuda.synchronize()
    _close(y, mf_ref.down_combine(h, wd, idx, sw, T), torch.float32)


@pytest.mark.cuda
def test_gather_swiglu_identity_index_matches_plain_on_card(cuda):
    """The a2a body's expert step at Qwen3-MoE's widths: kernel 3 over the
    2,048 dispatched slot rows (E 128, C 16) with the identity index, bf16,
    on the tensor cores: one bf16 ulp, bitwise on a repeated launch."""
    E, C, d, f = 128, 16, 4096, 1536
    g = torch.Generator(device=cuda).manual_seed(3)
    flat = torch.randn((E * C, d), generator=g, device=cuda).to(torch.bfloat16)
    wg, wu = ((torch.randn((E, d, f), generator=g, device=cuda) * d ** -0.5).to(torch.bfloat16) for _ in range(2))
    ident = torch.arange(E * C, dtype=torch.int32, device=cuda)
    h = mf_ops.gather_swiglu(flat, ident, wg, wu)
    torch.cuda.synchronize()
    _close(h, mf_ref.gather_swiglu(flat, ident, wg, wu), torch.bfloat16)
    assert torch.equal(h, mf_ops.gather_swiglu(flat, ident, wg, wu))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["small", "full"])
def test_flash_decode_window_kernel_matches_plain_on_card(cuda, dtype, shape):
    """Rolling buffers across the wrap point: small (T = 3 chains, a buffer
    with and without slack) and RecurrentGemma-2B's decode (10 heads over
    one KV head, hd 256, 2,048 slots, positions past several wraps)."""
    from repro_torch.kernels.flash_attention import ops as ops_

    if shape == "small":
        cases = [(3, 4, 2, 64, 24, 16, [2, 21, 75]), (3, 4, 1, 64, 16, 16, [30, 8, 15])]
    else:
        cases = [(1, 10, 1, 256, 2048, 2048, [0, 2047, 2100, 4160])]
    for T, nq, nkv, hd, W, window, idx in cases:
        B = len(idx)
        q, k, v = (_t(a).to(cuda, dtype) for a in _decode_case(W + T, B, T, nq, nkv, hd, W))
        pos = (torch.tensor(idx, dtype=torch.int32)[:, None] + torch.arange(T, dtype=torch.int32)).reshape(-1)
        pos = pos.to(cuda)
        got = ops_.flash_decode_window_kernel(q, k, v, pos, window=window)
        torch.cuda.synchronize()
        _close(got, fa_ref.flash_decode_window(q, k, v, pos, min(window, W)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["small", "full"])
def test_flash_attention_kernel_matches_plain_on_card(cuda, dtype, shape):
    """Causal and windowed, MQA and GQA, ragged last tiles; full width:
    RecurrentGemma-2B's prefill (q (1, 1200, 10, 256), window 512 standing
    in for 2,048 to keep the plain version quick) and Qwen3-MoE's (q (1, 128,
    64, 128) over 4 KV heads)."""
    from repro_torch.kernels.flash_attention import ops as ops_

    if shape == "small":
        cases = [(2, 37, 4, 1, 16, True, 8), (1, 45, 6, 3, 32, True, 0), (1, 70, 8, 2, 64, False, 0),
                 (2, 33, 16, 1, 128, True, 5)]
    else:
        cases = [(1, 1200, 10, 1, 256, True, 512), (1, 128, 64, 4, 128, True, 0)]
    for B, S, nq, nkv, hd, causal, window in cases:
        rng = np.random.default_rng(S)
        q = _t(rng.standard_normal((B, S, nq, hd)).astype(np.float32)).to(cuda, dtype)
        k, v = (_t(rng.standard_normal((B, S, nkv, hd)).astype(np.float32)).to(cuda, dtype) for _ in range(2))
        got = ops_.flash_attention_kernel(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        _close(got, fa_ref.flash_attention(q, k, v, causal=causal, window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["short_mid_exact", "window_below_W", "chain_across_wrap"])
def test_flash_decode_window_split_edges_on_card(cuda, dtype, case):
    """The split over chunks of ``WINDOW_CHUNK`` rows: visible runs shorter
    than one chunk, ending mid-chunk and exactly a multiple of it (one run
    wrapped); a window below the buffer's W; T = 3 chains whose launch
    crosses the wrap point (every split clipped by ``head - W + 1``).  Each
    held against the plain version, and a repeated launch bitwise equal."""
    from repro_torch.kernels.flash_attention import ops as ops_

    C = ops_.WINDOW_CHUNK
    if case == "short_mid_exact":  # runs of 11, C + 37, 2C and (wrapped) 4C rows
        T, nq, nkv, hd, W, window, idx = 1, 10, 1, 256, 4 * C, 4 * C, [10, C + 36, 2 * C - 1, 9 * C + 5]
    elif case == "window_below_W":
        T, nq, nkv, hd, W, window, idx = 1, 8, 2, 128, 4 * C, C + 29, [3, C + 28, 3 * C + 1, 11 * C + 7]
    else:
        T, nq, nkv, hd, W, window, idx = 3, 10, 1, 256, 2 * C + 3, 2 * C + 3, [2 * C + 1, 2 * C + 2, 5 * C, 1]
    B = len(idx)
    q, k, v = (_t(a).to(cuda, dtype) for a in _decode_case(W + T, B, T, nq, nkv, hd, W))
    pos = (torch.tensor(idx, dtype=torch.int32)[:, None] + torch.arange(T, dtype=torch.int32)).reshape(-1).to(cuda)
    got = ops_.flash_decode_window_kernel(q, k, v, pos, window=window)
    again = ops_.flash_decode_window_kernel(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, fa_ref.flash_decode_window(q, k, v, pos, min(window, W)), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,nq,nkv", [(256, 10, 1), (128, 16, 2), (256, 16, 1), (128, 10, 2), (96, 32, 32),
                                      (96, 4, 4), (160, 8, 2), (64, 32, 32), (64, 16, 4), (64, 10, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 45), (False, 0)])
def test_flash_attention_tensor_core_path_on_card(cuda, hd, nq, nkv, causal, window):
    """bf16 at hd 64, 96, 128, 160 and 256 takes the wgmma path: groups of
    10 (4 dead rows a 64-row tile), 16, 4 and 1, B = 2, S = 197 (a ragged
    last query tile and a ragged last key tile), window edges inside a
    64-key tile; at 96 and 160 the last 64-column box is part zeros and P.V
    runs at N = 96 and 160; hd 64 takes the template's lean softmax (only
    edge tiles masked, P.V issued 16 keys at a time).  Held by the bf16
    gate and bitwise equal on a repeated launch."""
    from repro_torch.kernels.flash_attention import ops as ops_

    assert ops_.flash_attention_path(torch.bfloat16, hd) == "tensor_cores"
    B, S = 2, 197
    rng = np.random.default_rng(hd + nq)
    q = _t(rng.standard_normal((B, S, nq, hd)).astype(np.float32)).to(cuda, torch.bfloat16)
    k, v = (_t(rng.standard_normal((B, S, nkv, hd)).astype(np.float32)).to(cuda, torch.bfloat16) for _ in range(2))
    got = ops_.flash_attention_kernel(q, k, v, causal=causal, window=window)
    again = ops_.flash_attention_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, fa_ref.flash_attention(q, k, v, causal=causal, window=window), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2048, 4096])
def test_flash_attention_hd64_musicgen_prompt_on_card(cuda, S):
    """MusicGen-large's heads (32 query and 32 KV heads of 64), one causal
    bf16 prompt of 2,048 and of 4,096 tokens, on the tensor cores: held by
    the bf16 gate against the plain version, bitwise equal on a repeated
    launch, and the LSE launch's O bitwise the serving launch's with its
    log-sum-exps within 1e-4 of the plain version's."""
    from repro_torch.kernels.flash_attention import ops as ops_

    assert ops_.flash_attention_path(torch.bfloat16, 64) == "tensor_cores"
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((1, S, 32, 64), generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    got = ops_.flash_attention_kernel(q, k, v, causal=True)
    assert torch.equal(got, ops_.flash_attention_kernel(q, k, v, causal=True))
    out, lse = ops_.flash_attention_lse_kernel(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(out, got)
    want, want_lse = fa_ref.flash_attention_lse(q, k, v, causal=True)
    _close(got, want, torch.bfloat16)
    assert float((lse - want_lse).abs().max()) <= 1e-4 * max(1.0, float(want_lse.abs().max()))


def _rglru_gates(seed, B, T, W, gates):
    """a in [0.5, 0.999) and b ~ 0.1 N(0, 1); with ``gates="edges"`` the
    first 8 channels take a = 0.05 (a chunk's product underflows to 0) and
    the next 8 a = 1 exactly."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, T, W)).astype(np.float32)
    if gates == "edges":
        a[:, :, :8] = 0.05
        a[:, :, 8:16] = 1.0
    b = (0.1 * rng.standard_normal((B, T, W))).astype(np.float32)
    return a, b, rng.standard_normal((B, W)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,W,with_h0,gates", [
    (2, 37, 100, True, "random"), (1, 4096, 2560, True, "random"), (2, 129, 102, True, "random"),
    (2, 1, 100, True, "random"), (2, 127, 100, False, "random"), (2, 129, 2560, True, "random"),
    (1, 2048, 2560, False, "random"), (1, 3072, 2560, True, "random"), (1, 4096, 2560, False, "random"),
    (2, 261, 100, True, "edges"), (1, 4096, 2560, False, "edges")])
def test_rglru_scan_kernel_matches_plain_on_card(cuda, dtype, B, T, W, with_h0, gates):
    """At 1e-4 of the scale, and bitwise equal on a repeated launch: T
    around the chunk (1, CHUNK - 1, CHUNK + 1) and the hybrid cell's
    prompts, W = 100 (a ragged tile), 102 (one channel a lane) and 2,560."""
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref

    assert rg_ops.CHUNK == 128  # the T cases above sit around it
    a, b, h0 = (_t(x) for x in _rglru_gates(T + W, B, T, W, gates))
    a, b = a.to(cuda, dtype), b.to(cuda, dtype)
    h0 = h0.to(cuda) if with_h0 else None
    got = rg_ops.rglru_scan(a, b, h0)
    again = rg_ops.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, T, W)
    assert torch.equal(got, again)
    _close(got, rg_ref.linear_scan(a, b, h0), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_builds_agree_bitwise_on_card(cuda, dtype):
    """The one-channel lanes (a and b one element past an aligned base) and
    the four-channel lanes compute the same operations in the same order."""
    from repro_torch.kernels.rglru_scan import ops as rg_ops

    B, T, W = 2, 300, 256
    a, b, h0 = (_t(x).to(cuda) for x in _rglru_gates(5, B, T, W, "random"))
    buf = torch.empty((2, B * T * W + 1), dtype=dtype, device=cuda)
    buf[0, 1:], buf[1, 1:] = a.reshape(-1), b.reshape(-1)
    a_off, b_off = (buf[i, 1:].view(B, T, W) for i in range(2))
    a, b = a.to(dtype), b.to(dtype)
    assert rg_ops.rglru_scan_path(W, True) == "vector"
    assert a_off.data_ptr() % (4 * a_off.element_size()) != 0
    assert torch.equal(rg_ops.rglru_scan(a, b, h0), rg_ops.rglru_scan(a_off, b_off, h0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,P,N,chunk,with_h0", [
    (2, 37, 3, 16, 16, 16, True), (1, 100, 4, 64, 128, 256, False), (2, 300, 2, 32, 64, 48, True),
    (1, 4096, 80, 64, 128, 256, False), (1, 4096, 80, 64, 128, 256, True),
    (1, 1, 4, 64, 128, 256, False), (1, 255, 4, 64, 128, 256, True), (2, 256, 4, 64, 128, 256, False),
    (1, 257, 4, 64, 128, 256, True), (1, 2100, 80, 64, 128, 256, True)])
def test_ssd_scan_kernel_matches_plain_on_card(cuda, dtype, B, T, H, P, N, chunk, with_h0):
    """y and the final state at 1e-4 of the scale, with and without h0,
    bitwise on a repeated launch.  bf16 at N 128, P 64 takes the
    tensor-core build (chunks of 256: T on and around the chunk edges, and
    Mamba-2-2.7B's admission, 80 heads of 64 over 4,096 steps); f32 and the
    other shapes the CUDA-core build (chunks of at most 64: the same
    function summed in another order).  x, B and C are read as views of
    one projection (the model's layout), through their strides."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    rng = np.random.default_rng(T)
    proj = _t((0.5 * rng.standard_normal((B, T, H * P + 2 * N))).astype(np.float32)).to(cuda, dtype)
    x = proj[..., :H * P].reshape(B, T, H, P)
    bm, cm = proj[..., H * P:H * P + N], proj[..., H * P + N:]
    dt = _t(np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)).to(cuda)
    a = -_t(np.linspace(1.0, 16.0, H).astype(np.float32)).to(cuda)
    h0 = _t(rng.standard_normal((B, H, N, P)).astype(np.float32)).to(cuda) if with_h0 else None
    want_path = "tensor_cores" if dtype == torch.bfloat16 and (N, P) == (128, 64) else "cuda_cores"
    assert ssd_ops.ssd_scan_path(dtype, N, P, ssd_ops.tma_ready(x, bm, cm)) == want_path
    y, h = ssd_ops.ssd_scan(x, dt, a, bm, cm, chunk, h0=h0)
    torch.cuda.synchronize()
    assert y.dtype == h.dtype == torch.float32 and bool(torch.isfinite(y).all())
    want_y, want_h = ssd_ref.ssd_chunked(x, dt, a, bm, cm, chunk, h0)
    _close(y, want_y, torch.float32)
    _close(h, want_h, torch.float32)
    y2, h2 = ssd_ops.ssd_scan(x, dt, a, bm, cm, chunk, h0=h0)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,k,C,d", [(37, 8, 2, 5, 100), (40, 8, 2, 16, 96), (128, 128, 8, 16, 4096)])
def test_moe_dispatch_kernels_match_plain_on_card(cuda, dtype, T, E, k, C, d):
    """Dispatch exactly; combine within one bf16 ulp (f32: 1e-4), with empty
    slots and, at C = 5, dropped assignments; d = 100 in bf16 is not a whole
    number of 16-byte vectors (the scalar path); the last case is the a2a
    body's admission shape."""
    from repro_torch.kernels.moe_dispatch import ops as md_
    from repro_torch.kernels.moe_dispatch import ref as mdr

    rng = np.random.default_rng(T + C)
    x = _t(rng.standard_normal((T, d)).astype(np.float32))
    plan, _ = route_topk(x, _t(rng.standard_normal((d, E)).astype(np.float32)), k, C)
    plan = type(plan)(*(f.to(cuda) for f in plan))
    xt = x.to(cuda, dtype)
    slots = md_.dispatch(xt, plan)
    torch.cuda.synchronize()
    assert torch.equal(slots, mdr.dispatch(xt, plan))
    y_slots = _t(rng.standard_normal((E, C, d)).astype(np.float32)).to(cuda, dtype)
    got = md_.combine(y_slots, plan)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _close(got, mdr.combine(y_slots, plan), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N", [(3, 37, 100, 130), (2, 16, 64, 256), (4, 20, 1536, 4096)])
def test_grouped_gemm_kernel_matches_plain_on_card(cuda, dtype, E, M, K, N):
    """Ragged M, K and N (N = 130: not a whole number of vectors in bf16),
    and the a2a down projection's K and N.  f32 and the ragged case take the
    CUDA-core build, the rest the tensor-core one."""
    from repro_torch.kernels.grouped_gemm import ops as gg
    from repro_torch.kernels.grouped_gemm import ref as ggr

    ragged = (K, N) == (100, 130)
    assert gg.grouped_gemm_path(dtype, K, N, True) == (
        "cuda_cores" if dtype == torch.float32 or ragged else "tensor_cores")
    rng = np.random.default_rng(M + N)
    x = _t(rng.standard_normal((E, M, K)).astype(np.float32)).to(cuda, dtype)
    w = _t((rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)).to(cuda, dtype)
    got = gg.grouped_gemm(x, w)
    torch.cuda.synchronize()
    assert got.shape == (E, M, N) and got.dtype == dtype
    _close(got, ggr.grouped_gemm(x, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("E,M,K,N", [(128, 16, 1536, 4096), (4, 8, 200, 328), (3, 37, 200, 328), (2, 300, 200, 328)])
def test_grouped_gemm_tensor_core_build_on_card(cuda, E, M, K, N):
    """The wgmma build at the a2a down projection's shape and at M 8, 37
    and 300 (M tiles of 16, 64 and 256 rows, the last two over the grid)
    with K and N multiples of 8 but not of 64, so TMA zero-fills the ragged
    edges: the bf16 gate against the plain version, and a repeated launch
    bitwise equal."""
    from repro_torch.kernels.grouped_gemm import ops as gg
    from repro_torch.kernels.grouped_gemm import ref as ggr

    assert gg.grouped_gemm_path(torch.bfloat16, K, N, True) == "tensor_cores"
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((E, M, K), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((E, K, N), generator=g, device=cuda) / K ** 0.5).to(torch.bfloat16)
    got = gg.grouped_gemm(x, w)
    assert torch.equal(got, gg.grouped_gemm(x, w))
    torch.cuda.synchronize()
    _close(got, ggr.grouped_gemm(x, w), torch.bfloat16)


# ---------------------------------------------------------------------------
# the int8 branches: bitwise the full-precision launch on the dequantized
# buffer (scales multiplied in before any dot), and close to the plain
# version as the f32 rows are
# ---------------------------------------------------------------------------


def _int8(a, axis):
    from repro_torch.core.quant import quantize_int8

    return quantize_int8(_t(a), axis=axis)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy", ["contiguous", "paged", "window"])
def test_flash_decode_int8_branch_is_the_dequantized_launch_on_card(cuda, qdtype, policy):
    tree = TreePlan.from_branching((2, 1))
    B, nq, nkv, hd, S, ps = 3, 16, 4, 128, 208, 16
    T = 1 if policy == "window" else tree.num_nodes
    q, k, v = _decode_case(7, B, T, nq, nkv, hd, S)
    (k8, ks), (v8, vs) = _int8(k, (-2, -1)), _int8(v, (-2, -1))
    ks, vs = ks[..., 0, 0], vs[..., 0, 0]
    kd, vd = (c.float() * s[..., None, None] for c, s in ((k8, ks), (v8, vs)))
    q32 = _t(q).to(cuda)
    k8, v8, kd, vd = (t.to(cuda) for t in (k8, v8, kd, vd))
    scales = torch.stack([ks, vs]).reshape(2, -1).contiguous().to(cuda)
    base = torch.tensor([0, 77, S - T - 3], dtype=torch.int32, device=cuda)
    lengths = (base[:, None] + torch.arange(1, T + 1, device=cuda, dtype=torch.int32)).reshape(-1).contiguous()
    words = torch.tensor(tree.ancestor_words(), dtype=torch.int32, device=cuda)
    if policy == "contiguous":
        def run(qq, kk, vv, sc):
            return fa_ops.flash_decode_kernel(qq, kk, vv, lengths, words, base, sc)
    elif policy == "paged":
        rng = np.random.default_rng(3)
        table = _t(rng.permutation(B * (S // ps)).astype(np.int32)).to(cuda)

        def run(qq, kk, vv, sc):
            return fa_ops.flash_decode_paged_kernel(qq, kk.reshape(B * S, nkv, hd), vv.reshape(B * S, nkv, hd),
                                                    lengths, table, words, base, sc, page_size=ps)
    else:
        pos = torch.tensor([5, 300, 1000], dtype=torch.int32, device=cuda)  # two of three wrapped

        def run(qq, kk, vv, sc):
            return fa_ops.flash_decode_window_kernel(qq, kk, vv, pos, sc, window=160)
    qq = q32.to(qdtype)
    got = run(qq, k8, v8, scales)
    want = run(qq.float(), kd, vd, None).to(qdtype)  # a bf16 q reads the same f32 values; one rounding at the end
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = {"contiguous": lambda: fa_ref.flash_decode(qq, k8, v8, lengths, words, base, scales),
             "paged": lambda: fa_ref.flash_decode_paged(qq, k8.reshape(B * S, nkv, hd), v8.reshape(B * S, nkv, hd),
                                                        lengths, table, words, base, ps, scales),
             "window": lambda: fa_ref.flash_decode_window(qq, k8, v8, pos, 160, scales)}[policy]()
    _close(got, plain, qdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_decode_moe_int8_branch_is_the_dequantized_launch_on_card(cuda, xdtype):
    T, k, E, d, f = 5, 4, 16, 256, 192
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((T, d)).astype(np.float32)).to(cuda, xdtype)
    ids = _t(np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)).to(cuda)
    w = _t(rng.random((T, k)).astype(np.float32)).to(cuda)
    twins = [_int8(a, (1, 2)) for a in _moe_stacks(5, E, d, f)]
    stacks = [q.to(cuda) for q, _ in twins]
    scales = torch.stack([s[:, 0, 0] for _, s in twins]).to(cuda)
    deq = [q.float() * s[:, None, None] for q, s in zip(stacks, scales)]
    got = md_ops.decode_moe_kernel(x, ids, w, *stacks, scales)
    torch.cuda.synchronize()
    assert torch.equal(got, md_ops.decode_moe_kernel(x.float(), ids, w, *deq))
    _close(got, md_ref.decode_moe(x, ids, w, *stacks, scales), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_down_combine_is_fixed_order_on_card(cuda, dtype):
    """Repeated launches are bitwise equal, including a token named by more
    slots than one pass of the combine lists (80 > 64) and tokens no slot
    names (zeros)."""
    E, C, f, d, T = 80, 3, 64, 96, 6
    rng = np.random.default_rng(9)
    idx = np.full((E, C), T, np.int32)
    idx[:, 0] = 0                      # token 0: one slot of every expert
    idx[: E // 2, 1] = 2               # token 2: 40 slots
    idx[5, 2], idx[70, 2] = 4, 4       # token 4: two slots; tokens 1, 3, 5: none
    idx = _t(idx.reshape(-1)).to(cuda)
    sw = _t(rng.random(E * C).astype(np.float32)).to(cuda)
    h = _t(rng.standard_normal((E, C, f)).astype(np.float32)).to(cuda, dtype)
    wd = _t(rng.standard_normal((E, f, d)).astype(np.float32) / 8).to(cuda, dtype)
    first = mf_ops.down_combine(h, wd, idx, sw, T)
    for _ in range(3):
        assert torch.equal(mf_ops.down_combine(h, wd, idx, sw, T), first)
    torch.cuda.synchronize()
    assert bool((first[[1, 3, 5]] == 0).all())
    _close(first, mf_ref.down_combine(h, wd, idx, sw, T), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,d,f", [(40, 8, 96, 80), (128, 16, 5120, 8192)])
def test_fused_moe_kernels_top1_on_card(cuda, dtype, T, E, d, f):
    """Kernels 3 and 4 over a top-1 plan (Llama-4's routing; at its widths d
    5120, f 8192 over 16 experts too): within one bf16 ulp (f32 1e-4) of
    the plain versions, bitwise on a repeated launch."""
    rng = np.random.default_rng(T)
    x = _t(rng.standard_normal((T, d)).astype(np.float32))
    router = _t(rng.standard_normal((d, E)).astype(np.float32))
    C = T  # no drops: every token's one expert keeps it
    plan, _ = route_topk(x, router, 1, C)
    assert int((plan.flat_idx < T).sum()) == T and bool((plan.slot_w[plan.flat_idx < T] == 1.0).all())
    idx, sw = plan.flat_idx.to(cuda), plan.slot_w.to(cuda)
    xt = x.to(cuda, dtype)
    g = torch.Generator(device=cuda).manual_seed(T)
    wg, wu = ((torch.randn((E, d, f), generator=g, device=cuda) * d ** -0.5).to(dtype) for _ in range(2))
    wd = (torch.randn((E, f, d), generator=g, device=cuda) * f ** -0.5).to(dtype)
    h = mf_ops.gather_swiglu(xt, idx, wg, wu)
    assert torch.equal(h, mf_ops.gather_swiglu(xt, idx, wg, wu))
    torch.cuda.synchronize()
    _close(h, mf_ref.gather_swiglu(xt, idx, wg, wu), dtype)
    y = mf_ops.down_combine(h, wd, idx, sw, T)
    assert torch.equal(y, mf_ops.down_combine(h, wd, idx, sw, T))
    torch.cuda.synchronize()
    _close(y, mf_ref.down_combine(h, wd, idx, sw, T), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [torch.float32, torch.bfloat16, "int8"])
@pytest.mark.parametrize("hd,nq,nkv", [(96, 4, 4), (160, 8, 2)])
def test_decode_kernels_at_head_dims_96_and_160_on_card(cuda, kv, hd, nq, nkv):
    """Kernels 1 and 5 (and their int8 branches) at Phi-3-Vision's head dim
    96 with G = 1 (192 of a block's 256 threads own a P.V (group, dim)
    pair) and StableLM-12B's 160 with G = 4 (160 of 256): split edges
    around the 64-row chunks, chain and tree words, against the plain
    version and bitwise on a repeat; the paged launch with the identity
    table is bitwise the contiguous one."""
    tree = TreePlan.from_branching((2, 1))
    T, S = tree.num_nodes, 240
    for policy in ("contiguous", "paged"):
        q, run, plain = _decode_inputs(cuda, policy, kv, T, S, nq=nq, nkv=nkv, hd=hd, seed=hd)
        words = torch.tensor(tree.ancestor_words(), dtype=torch.int32, device=cuda)
        full = torch.full((T,), -1, dtype=torch.int32, device=cuda)
        for L in (1, 63, 64, 65, 212, S):
            lengths = torch.tensor([[max(1, n - T + 1 + t) for t in range(T)] for n in (L, S + 1 - L)],
                                   dtype=torch.int32, device=cuda).reshape(-1)
            base = (lengths.reshape(2, T)[:, 0] - 1).contiguous()
            for w in (None, words):
                got = run(lengths, w, base)
                assert torch.equal(got, run(lengths, w, base)), (policy, L)
                torch.cuda.synchronize()
                _close(got, plain(lengths, full if w is None else w, base), q.dtype)
    dt = torch.bfloat16 if kv == "int8" else kv
    if kv != "int8":
        q, k, v = (_t(a).to(cuda, dt) for a in _decode_case(hd + 1, 2, T, nq, nkv, hd, S))
        lengths = torch.tensor([5, 6, 7, 8, 200, 201, 202, 203], dtype=torch.int32, device=cuda)
        ident = torch.arange(2 * S // 16, dtype=torch.int32, device=cuda)
        paged = fa_ops.flash_decode_paged_kernel(q, k.reshape(2 * S, nkv, hd), v.reshape(2 * S, nkv, hd), lengths,
                                                 ident, page_size=16)
        assert torch.equal(paged, fa_ops.flash_decode_kernel(q, k, v, lengths))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,nq,nkv", [(96, 4, 4), (160, 8, 2)])
def test_window_and_prefill_kernels_at_head_dims_96_and_160_on_card(cuda, dtype, hd, nq, nkv):
    """Kernel 6 (rolling buffers across the wrap, T = 3) and kernel 7
    (causal and windowed, ragged tiles; the CUDA-core build in f32, the
    tensor-core build in bf16) at head dims 96 and 160, against their plain
    versions."""
    T, W, window, idx = 3, 80, 70, [2, 63, 150, 400]
    B = len(idx)
    q, k, v = (_t(a).to(cuda, dtype) for a in _decode_case(hd, B, T, nq, nkv, hd, W))
    pos = (torch.tensor(idx, dtype=torch.int32)[:, None] + torch.arange(T, dtype=torch.int32)).reshape(-1).to(cuda)
    got = fa_ops.flash_decode_window_kernel(q, k, v, pos, window=window)
    assert torch.equal(got, fa_ops.flash_decode_window_kernel(q, k, v, pos, window=window))
    torch.cuda.synchronize()
    _close(got, fa_ref.flash_decode_window(q, k, v, pos, min(window, W)), dtype)
    assert fa_ops.flash_attention_path(dtype, hd) == ("tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")
    for B, S, causal, win in ((2, 77, True, 0), (1, 130, True, 33), (1, 45, False, 0)):
        rng = np.random.default_rng(S + hd)
        q = _t(rng.standard_normal((B, S, nq, hd)).astype(np.float32)).to(cuda, dtype)
        k, v = (_t(rng.standard_normal((B, S, nkv, hd)).astype(np.float32)).to(cuda, dtype) for _ in range(2))
        got = fa_ops.flash_attention_kernel(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        _close(got, fa_ref.flash_attention(q, k, v, causal=causal, window=win), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 96, 128, 160, 256])
def test_cuda_core_entry_refuses_bf16_at_the_tensor_core_head_dims_on_card(cuda, hd):
    """``repro_flash_attention`` (the CUDA-core build) returns an error for
    bf16 at every head dim the tensor-core build takes, so no caller reaches
    the slower build by calling it; f32 at the same head dim launches."""
    from repro_torch import kernels

    fn = kernels.function("flash_attention", "repro_flash_attention", fa_ops._FA_ARGTYPES)
    for dtype, refused in ((torch.bfloat16, True), (torch.float32, False)):
        q = torch.zeros((1, 9, 2, hd), dtype=dtype, device=cuda)
        out = torch.empty_like(q)
        rc = fn(kernels.dtype_code(dtype), q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), 1, 9, 9, 2, 2,
                hd, 1, 0, 0.1, kernels.stream_of(q))
        torch.cuda.synchronize()
        assert (rc != 0) == refused, (dtype, rc)


def test_head_dims_outside_the_builds_raise():
    """A head dim no kernel is built for raises before any launch (on the
    CPU the plain version would compute it; on the card there is no
    kernel, and nothing falls back)."""
    q = torch.zeros((1, 1, 2, 80))
    k = torch.zeros((1, 8, 2, 80))
    lengths = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim 80 not in"):
        fa_ops._launch_decode("repro_flash_decode", q, k, k, (), lengths, None, None, None, (8,), 8, 2,
                              "flash_decode")
    assert 96 in fa_ops._HEAD_DIMS and 160 in fa_ops._HEAD_DIMS


# ---------------------------------------------------------------------------
# kernel 7's backward (training): the LSE forward and the three-launch
# backward against their plain versions
# ---------------------------------------------------------------------------

# B, S, nq, nkv, hd, causal, window: MHA, GQA up to StarCoder2-3B's group
# of 12, ragged last tiles, windows, and every head dim of the builds; in
# bf16 every case from hd 64 up is the tensor-core build's, and the tc_*
# cases are written for it: S not a multiple of 64, batch 2, G = 1, 4, 8, 10
# and 12, causal windows, a bidirectional window and no mask (hd 256 at
# RecurrentGemma-2B's group of 10: hd256_g10_w30 under a window of 30,
# tc_hd256_g10_b2 ragged at batch 2)
BWD_CASES = {
    "hd16_g2_w7": (2, 33, 4, 2, 16, True, 7),
    "hd32_noncausal": (1, 45, 6, 3, 32, False, 0),
    "hd64_mha": (2, 70, 4, 4, 64, True, 0),
    "hd96_mha_w45": (1, 130, 4, 4, 96, True, 45),
    "hd128_g12": (1, 200, 24, 2, 128, True, 0),
    "hd160_g4": (1, 150, 8, 2, 160, True, 0),
    "hd256_g10_w30": (1, 100, 10, 1, 256, True, 30),
    "tc_hd64_g8_b2": (2, 131, 16, 2, 64, True, 0),
    "tc_hd64_g1_noncausal": (1, 97, 4, 4, 64, False, 0),
    "tc_hd96_g12_w70": (1, 260, 12, 1, 96, True, 70),
    "tc_hd96_g4_b2": (2, 65, 8, 2, 96, True, 0),
    "tc_hd128_g12_b2": (2, 150, 24, 2, 128, True, 0),
    "tc_hd128_g8_w100": (1, 333, 16, 2, 128, True, 100),
    "tc_hd128_g1_b2_w33": (2, 190, 4, 4, 128, True, 33),
    "tc_hd160_g4_b2_w45": (2, 211, 8, 2, 160, True, 45),
    "tc_hd160_g8_bidir_w50": (1, 140, 8, 1, 160, False, 50),
    "tc_hd160_g1": (1, 64, 2, 2, 160, True, 0),
    "tc_hd256_g10_b2": (2, 161, 10, 1, 256, True, 0),
}


def _bwd_inputs(cuda, dtype, case):
    B, S, nq, nkv, hd, causal, window = BWD_CASES[case]
    rng = np.random.default_rng(S + hd)
    q, do = (_t(rng.standard_normal((B, S, nq, hd)).astype(np.float32)).to(cuda, dtype) for _ in range(2))
    k, v = (_t(rng.standard_normal((B, S, nkv, hd)).astype(np.float32)).to(cuda, dtype) for _ in range(2))
    return q, k, v, do, causal, window


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_attention_lse_forward_matches_plain_on_card(cuda, dtype, case):
    """The LSE instantiation's O is bitwise the serving launch's; its
    log-sum-exps agree with the plain version's to 1e-4 (f32 sums in
    another order, in base 2 on the tensor cores)."""
    q, k, v, _, causal, window = _bwd_inputs(cuda, dtype, case)
    out, lse = fa_ops.flash_attention_lse_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, fa_ops.flash_attention_kernel(q, k, v, causal=causal, window=window))
    _, want = fa_ref.flash_attention_lse(q, k, v, causal=causal, window=window)
    assert float((lse - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_attention_bwd_matches_plain_on_card(cuda, dtype, case, monkeypatch):
    """dQ, dK, dV against the plain backward on the same inputs (the
    kernel's own O and lse), with the forward's gate; a repeat is bitwise;
    the launch takes the C entry of the build ``flash_attention_bwd_path``
    names (the tensor cores for bf16 at hd 64, 96, 128, 160 and 256)."""
    q, k, v, do, causal, window = _bwd_inputs(cuda, dtype, case)
    out, lse = fa_ops.flash_attention_lse_kernel(q, k, v, causal=causal, window=window)
    path = fa_ops.flash_attention_bwd_path(dtype, q.shape[-1])
    assert path == ("tensor_cores" if dtype == torch.bfloat16 and q.shape[-1] in fa_ops._FA_BWD_TC_HEAD_DIMS
                    else "cuda_cores")
    symbols, real = [], fa_ops.function
    monkeypatch.setattr(fa_ops, "function", lambda name, symbol, argtypes: symbols.append(symbol)
                        or real(name, symbol, argtypes))
    before = fa_ops.flash_attention_bwd_kernel.launches
    got = fa_ops.flash_attention_bwd_kernel(q, k, v, out, lse, do, causal=causal, window=window)
    again = fa_ops.flash_attention_bwd_kernel(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_bwd_kernel.launches == before + 2
    entry = "repro_flash_attention_bwd_tc" if path == "tensor_cores" else "repro_flash_attention_bwd"
    assert symbols == [entry, entry]
    want = fa_ref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, a)
        _close(g, w, dtype)


@pytest.mark.cuda
def test_flash_attention_train_runs_the_kernels_on_card(cuda):
    """The autograd entry point on the card: the forward counts one launch
    of kernel 7, the backward one of its backward, and the gradients are
    the backward kernel's on the forward's O and lse."""
    q, k, v, do, causal, window = _bwd_inputs(cuda, torch.bfloat16, "hd128_g12")
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    f0, b0 = fa_ops.flash_attention_kernel.launches, fa_ops.flash_attention_bwd_kernel.launches
    out = fa_ops.flash_attention_train(qg, kg, vg, causal=causal, window=window)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa_ops.flash_attention_kernel.launches - f0, fa_ops.flash_attention_bwd_kernel.launches - b0) == (1, 1)
    o2, lse = fa_ops.flash_attention_lse_kernel(q, k, v, causal=causal, window=window)
    assert torch.equal(out.detach(), o2)
    want = fa_ops.flash_attention_bwd_kernel(q, k, v, o2, lse, do, causal=causal, window=window)
    for t, w in zip((qg, kg, vg), want):
        assert torch.equal(t.grad, w)
