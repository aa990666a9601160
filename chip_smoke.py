#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the full-width main
path gives it (and times both, beside the card's bound and one PyTorch call
where one computes the same function), serves the f32 smoke twin on the card
and on the CPU (greedy streams must be identical), then serves
Qwen3-MoE-235B-A22B at full width, cut to 4 layers, on the Agile decode
plane (spec 4, ngram drafter) and shows that every kernel ran.  Each phase
prints one JSON line; the full record also goes to
``chiprun_out/chip_smoke.json``.  The last line is
``{"ok": true, "device": {...}}``; any failed phase exits non-zero before it.
Needs one card, no network, and imports no jax.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen3-moe-235b-a22b"
LAYERS = 4                  # of 94: the full depth does not fit one 80 GB card
SLOTS, PROMPT, GEN, REQUESTS, SPEC = 4, 128, 32, 8, 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor rate, published

RECORD: dict = {}


def emit(phase: str, **fields) -> None:
    RECORD[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, tol_rel):
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    if not err <= tol_rel * scale:
        raise AssertionError(f"{name}: max |kernel - plain| {err:.3e} exceeds {tol_rel:.0e} x {scale:.3g}")
    return err


def check_bf16(name, got, want):
    """Elementwise hold for bf16 outputs.  Kernel and plain version both
    compute in f32 and round once to bf16, so an element may differ by one
    bf16 ulp (at most 2^-7 of its value) where the two f32 sums straddle a
    rounding boundary; the 1e-3 x rms floor covers elements that cancel to
    near zero.  A kernel that accumulated in bf16 would miss it by far."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    lim = 2.0 ** -7 * w.abs() + 1e-3 * float(w.pow(2).mean().sqrt())
    bad = int((err > lim).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} of {err.numel()} elements differ by more than "
                             f"2^-7 |plain| + 1e-3 rms (max |kernel - plain| {float(err.max()):.3e})")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at full-width shapes
# ---------------------------------------------------------------------------


def kernel_phase(cfg, dev):
    import torch

    from repro_torch.core.control_plane import capacity_for, route_topk, route_topk_decode
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.moe_decode import ops as md_ops
    from repro_torch.kernels.moe_decode import ref as md_ref
    from repro_torch.kernels.moe_fused import ops as mf_ops
    from repro_torch.kernels.moe_fused import ref as mf_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    # f32 vs plain: sums in another order (atomics in down_combine) -> 1e-4
    # relative; bf16 outputs (flash, gather_swiglu): check_bf16, elementwise;
    # f32 outputs from bf16 inputs keep the f32 bound
    tol = {"f32": 1e-4, "f32_out": 1e-4}
    rows = {}
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    E, k, f = cfg.num_experts, cfg.top_k, cfg.d_ff_expert
    max_len = PROMPT + GEN + SPEC

    # ---- flash_decode: B = 4 slots x T = 4 chain tokens over a 164-row cache
    B, T = SLOTS, SPEC
    base = torch.tensor([70, 100, 130, max_len - SPEC], dtype=torch.int32, device=dev)
    lengths = (base[:, None] + torch.arange(1, T + 1, dtype=torch.int32, device=dev)).reshape(-1).contiguous()
    chain = torch.full((T,), -1, dtype=torch.int32, device=dev)
    q32 = torch.randn((B, T, nq, hd), generator=gen, device=dev)
    k32 = torch.randn((B, max_len, nkv, hd), generator=gen, device=dev)
    v32 = torch.randn((B, max_len, nkv, hd), generator=gen, device=dev)
    err32 = check_close("flash_decode f32", fa_ops.flash_decode_kernel(q32, k32, v32, lengths, chain, base),
                        fa_ref.flash_decode(q32, k32, v32, lengths, chain, base), tol["f32"])
    words = torch.tensor([1, 3, 5, 11], dtype=torch.int32, device=dev)  # a hand-made tree
    check_close("flash_decode tree", fa_ops.flash_decode_kernel(q32, k32, v32, lengths, words, base),
                fa_ref.flash_decode(q32, k32, v32, lengths, words, base), tol["f32"])
    q, kk, vv = q32.to(bf16), k32.to(bf16), v32.to(bf16)
    err = check_bf16("flash_decode bf16", fa_ops.flash_decode_kernel(q, kk, vv, lengths, chain, base),
                     fa_ref.flash_decode(q, kk, vv, lengths, chain, base))
    mask = (torch.arange(max_len, device=dev)[None, None, :] < lengths.reshape(B, T)[:, :, None])[:, None]
    # the GQA expansion is set-up: one call computes attention on its result
    qt = q.transpose(1, 2)
    kt, vt = (c.transpose(1, 2).repeat_interleave(nq // nkv, 1) for c in (kk, vv))

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    L = lengths.reshape(B, T).long()
    kv_rows = int(L.max(dim=1).values.sum())
    nbytes = 2 * q.numel() * 2 + kv_rows * nkv * hd * 2 * 2 + (B * T + T + B) * 4
    flops = float(L.sum()) * nq * hd * 4
    rows["flash_decode"] = dict(
        max_abs_err=err, max_abs_err_f32=err32,
        ms=time_ms(lambda: fa_ops.flash_decode_kernel(q, kk, vv, lengths, chain, base), iters=50),
        plain_ms=time_ms(lambda: fa_ref.flash_decode(q, kk, vv, lengths, chain, base)),
        library_ms=time_ms(lib, iters=50), library_call="scaled_dot_product_attention (boolean mask, kv heads expanded beforehand)",
        shapes=f"q {tuple(q.shape)}, kv {tuple(kk.shape)}, lengths {lengths.tolist()}",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    del q32, k32, v32, q, kk, vv, qt, kt, vt

    # ---- decode_moe: 16 decode tokens (4 slots x spec 4), top-8 of 128 experts
    Tt = B * T
    x32 = torch.randn((Tt, d), generator=gen, device=dev)
    router = torch.randn((d, E), generator=gen, device=dev) * 0.02
    plan = route_topk_decode(x32, router, k)
    ids, w = plan.expert_ids.contiguous(), plan.weights.contiguous()
    stacks32 = [torch.randn(s, generator=gen, device=dev) * a for s, a in
                (((E, d, f), d ** -0.5), ((E, d, f), d ** -0.5), ((E, f, d), f ** -0.5))]
    err32 = check_close("decode_moe f32", md_ops.decode_moe_kernel(x32, ids, w, *stacks32),
                        md_ref.decode_moe(x32, ids, w, *stacks32), tol["f32"])
    del stacks32
    torch.cuda.empty_cache()
    x = x32.to(bf16)
    wg, wu, wd = (torch.randn(s, generator=gen, device=dev, dtype=bf16) * a for s, a in
                  (((E, d, f), d ** -0.5), ((E, d, f), d ** -0.5), ((E, f, d), f ** -0.5)))
    err = check_close("decode_moe bf16", md_ops.decode_moe_kernel(x, ids, w, wg, wu, wd),
                      md_ref.decode_moe(x, ids, w, wg, wu, wd), tol["f32_out"])
    distinct = int(torch.unique(ids).numel())

    def composite_decode():
        e = ids.reshape(-1).long()
        xs = x.repeat_interleave(k, 0)[:, None]
        h = torch.nn.functional.silu(torch.bmm(xs, wg[e])) * torch.bmm(xs, wu[e])
        return (torch.bmm(h, wd[e])[:, 0].float() * w.reshape(-1, 1)).reshape(Tt, k, d).sum(1)

    nbytes = distinct * 3 * d * f * 2 + Tt * d * 2 + Tt * k * 8 + Tt * d * 4
    flops = Tt * k * 6.0 * d * f
    rows["decode_moe"] = dict(
        max_abs_err=err, max_abs_err_f32=err32,
        ms=time_ms(lambda: md_ops.decode_moe_kernel(x, ids, w, wg, wu, wd), iters=20),
        plain_ms=time_ms(lambda: md_ref.decode_moe(x, ids, w, wg, wu, wd), iters=3, reps=3),
        library_ms=None, library_call=None,
        composite_ms=time_ms(composite_decode, iters=3, reps=3),
        composite_call="gather of the named experts' stacks + torch.bmm x3",
        shapes=f"x {tuple(x.shape)}, top-{k} of {E} experts ({distinct} distinct), d {d}, f {f}",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )

    # ---- fused prefill pair: one 128-token admission prompt
    Tp = PROMPT
    C = capacity_for(Tp, E, k, cfg.capacity_factor)
    xp32 = torch.randn((Tp, d), generator=gen, device=dev)
    pplan, _ = route_topk(xp32, router, k, C)
    idx, sw = pplan.flat_idx.contiguous(), pplan.slot_w.contiguous()
    occ = idx < Tp
    n_occ = int(occ.sum())
    used = int(occ.reshape(E, C).any(1).sum())
    xp = xp32.to(bf16)
    h = mf_ops.gather_swiglu(xp, idx, wg, wu)
    err_g = check_bf16("gather_swiglu bf16", h, mf_ref.gather_swiglu(xp, idx, wg, wu))
    err_d = check_close("down_combine bf16", mf_ops.down_combine(h, wd, idx, sw, Tp),
                        mf_ref.down_combine(h, wd, idx, sw, Tp), tol["f32_out"])
    del wg, wu
    torch.cuda.empty_cache()
    wg32 = torch.randn((E, d, f), generator=gen, device=dev) * d ** -0.5
    wu32 = torch.randn((E, d, f), generator=gen, device=dev) * d ** -0.5
    h32 = mf_ops.gather_swiglu(xp32, idx, wg32, wu32)
    err_g32 = check_close("gather_swiglu f32", h32, mf_ref.gather_swiglu(xp32, idx, wg32, wu32), tol["f32"])
    del wg32, wu32
    torch.cuda.empty_cache()
    wd32 = wd.float()
    err_d32 = check_close("down_combine f32", mf_ops.down_combine(h32, wd32, idx, sw, Tp),
                          mf_ref.down_combine(h32, wd32, idx, sw, Tp), tol["f32"])
    del wd32, h32
    torch.cuda.empty_cache()
    wg, wu = (torch.randn((E, d, f), generator=gen, device=dev, dtype=bf16) * d ** -0.5 for _ in range(2))
    h = mf_ops.gather_swiglu(xp, idx, wg, wu)

    def composite_gather():
        slots = torch.cat([xp, xp.new_zeros((1, d))])[idx.long()].reshape(E, C, d)
        return torch.nn.functional.silu(torch.bmm(slots, wg)) * torch.bmm(slots, wu)

    def composite_down():
        y = torch.bmm(h, wd).reshape(E * C, d).float() * sw[:, None]
        return torch.zeros((Tp + 1, d), device=dev).index_add_(0, idx.long(), y)[:Tp]

    shapes = f"x {tuple(xp.shape)}, E {E}, C {C} ({n_occ} slots occupied, {used} experts used), d {d}, f {f}"
    nbytes = used * 2 * d * f * 2 + Tp * d * 2 + E * C * 4 + E * C * f * 2
    flops = n_occ * 4.0 * d * f
    rows["gather_swiglu"] = dict(
        max_abs_err=err_g, max_abs_err_f32=err_g32,
        ms=time_ms(lambda: mf_ops.gather_swiglu(xp, idx, wg, wu), iters=10),
        plain_ms=time_ms(lambda: mf_ref.gather_swiglu(xp, idx, wg, wu), iters=3, reps=3),
        library_ms=None, library_call=None,
        composite_ms=time_ms(composite_gather, iters=5, reps=3), composite_call="index gather + torch.bmm x2",
        shapes=shapes, bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    nbytes = used * f * d * 2 + n_occ * f * 2 + E * C * 8 + Tp * d * 4
    flops = n_occ * 2.0 * f * d
    rows["down_combine"] = dict(
        max_abs_err=err_d, max_abs_err_f32=err_d32,
        ms=time_ms(lambda: mf_ops.down_combine(h, wd, idx, sw, Tp), iters=10),
        plain_ms=time_ms(lambda: mf_ref.down_combine(h, wd, idx, sw, Tp), iters=3, reps=3),
        library_ms=None, library_call=None,
        composite_ms=time_ms(composite_down, iters=5, reps=3), composite_call="torch.bmm + index_add_",
        shapes=shapes, bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------


def smoke_twin(dev):
    """The f32 smoke config served on the card (kernels) and on the CPU
    (plain versions) from the same weights: greedy streams identical.  At
    spec 4 some drafts must be accepted, so the plan-row selection by
    ``prev_accept > 0`` runs on the card."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import kernel_wrappers, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    out = {}
    for spec, drafter in ((1, "ngram"), (4, "repeat"), (4, "ngram")):
        cfg = dataclasses.replace(get_smoke_config(ARCH), decode_plane=True, spec_tokens=spec)
        params_cpu = Model(cfg, device="cpu").init(0)
        params_gpu = _to(params_cpu, dev)
        reqs = serve.synthetic_requests(cfg.vocab_size, 16, 8, 6)
        max_len = 16 + 8 + spec
        reset_launch_counts()
        rep = serve.ServeReplica(cfg, 3, max_len, params_gpu, drafter=drafter, device=dev)
        gpu = serve.serve_queue(rep, reqs)
        torch.cuda.synchronize()
        counts = {n: w.launches for n, w in kernel_wrappers().items()}
        cpu = serve.serve_queue(serve.ServeReplica(cfg, 3, max_len, params_cpu, drafter=drafter, device="cpu"), reqs)
        g = {rid: r.tokens for rid, r in gpu.items()}
        c = {rid: r.tokens for rid, r in cpu.items()}
        tag = f"smoke twin spec {spec} {drafter}"
        if g != c:
            raise AssertionError(f"{tag}: card streams {g} != CPU streams {c}")
        if min(counts.values()) <= 0:
            raise AssertionError(f"{tag}: a kernel never launched: {counts}")
        # every active slot keeps its first token each launch; the rest of
        # what it keeps are accepted drafts
        draft_accepts = rep.accepted_total - rep.drafted_total // spec
        if spec > 1 and draft_accepts <= 0:
            raise AssertionError(f"{tag}: no draft token was ever accepted on the card")
        out[f"spec{spec}_{drafter}"] = dict(
            streams_identical=True, requests=len(g), launches=counts, decode_launches=rep.launches,
            accepted_total=rep.accepted_total, drafted_total=rep.drafted_total, draft_accepts=draft_accepts,
        )
    return out


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def full_width(dev):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import kernel_wrappers, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(ARCH), num_layers=LAYERS, decode_plane=True, spec_tokens=SPEC)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    max_len = PROMPT + GEN + SPEC
    reqs = serve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, REQUESTS)
    rep = serve.ServeReplica(cfg, SLOTS, max_len, params, drafter="ngram", device=dev)
    # warm-up outside the measured run: one request through admission and decode
    serve.serve_queue(rep, serve.synthetic_requests(cfg.vocab_size, PROMPT, 4, 1))
    for name in ("launches", "prefills", "accepted_total", "drafted_total", "prefill_ms", "decode_ms"):
        setattr(rep, name, type(getattr(rep, name))(0))
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    results = serve.serve_queue(rep, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in kernel_wrappers().items()}

    streams = {rid: r.tokens for rid, r in results.items()}
    if sorted(streams) != list(range(REQUESTS)) or any(r.error for r in results.values()):
        raise AssertionError(f"full width: unanswered or failed requests: {results}")
    for rid, toks in streams.items():
        if len(toks) != GEN + 1 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"full width: request {rid} stream malformed: {toks}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"full width: a kernel never launched on the main path: {counts}")
    one = model.init_cache(1, max_len)
    logits = model.prefill(params, reqs[0].prompt[None], one)
    if not (logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all())):
        raise AssertionError("full width: prefill logits not finite or of the wrong shape")
    served = dict(
        layers=LAYERS, layers_published=get_config(ARCH).num_layers, dtype=cfg.dtype,
        slots=SLOTS, prompt_len=PROMPT, gen=GEN, requests=REQUESTS, spec_tokens=SPEC, drafter="ngram",
        weight_bytes=weight_bytes, init_s=init_s, peak_memory_bytes=torch.cuda.max_memory_allocated(),
        wall_s=wall, generated_tokens=rep.accepted_total, tok_per_s=rep.accepted_total / wall,
        decode_launches=rep.launches, ms_per_decode_launch=rep.decode_ms / max(rep.launches, 1),
        prefills=rep.prefills, prefill_ms_mean=rep.prefill_ms / max(rep.prefills, 1),
        accepts_per_launch=rep.accepted_total / max(rep.launches, 1),
        accept_rate=rep.accepted_total / max(rep.drafted_total, 1),
        kernel_launches=counts, streams=streams,
    )
    # launches of each kernel in one admission and in one decode launch
    wrappers = kernel_wrappers()
    reset_launch_counts()
    rep.admit(reqs[0])
    per_admission = {n: w.launches for n, w in wrappers.items()}
    reset_launch_counts()
    rep.step()
    per_decode = {n: w.launches for n, w in wrappers.items()}
    while rep.has_work():
        rep.step()
    served["launches_per_step"] = {
        n: dict(per_decode_launch=per_decode[n], per_admission=per_admission[n]) for n in wrappers
    }
    return served, rep


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def profile_decode(rep, vocab):
    """Device time by kernel over a short steady window of decode launches.

    The profiler's own host overhead lengthens the launches it records, so
    the idle share divides the device-busy time per launch by the wall time
    per launch of an unprofiled window of the same length just before it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    n = 3
    for r in serve.synthetic_requests(vocab, PROMPT, GEN, SLOTS):
        rep.admit(r)
    rep.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        rep.step()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            rep.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    while rep.has_work():
        rep.step()
    # count device-side events only: CPU ops also report the device time of
    # the kernels they launched, which would count those kernels twice
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            name = ev.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0][:90]
            by_name[name] = by_name.get(name, 0.0) + us / 1e3
    if not by_name:
        return dict(measured=False, note="the profiler showed no device time")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(measured=True, launches=n, wall_ms_unprofiled=plain_wall_ms, wall_ms_profiled=wall_ms,
                device_busy_ms=busy, device_idle_share=max(0.0, 1 - busy / plain_wall_ms),
                device_idle_share_profiled=max(0.0, 1 - busy / wall_ms), top_kernels_ms=dict(top))


# ---------------------------------------------------------------------------


KERNELS = {
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/decode.py:162"),
    "decode_moe": ("src/repro_torch/csrc/moe_decode.cu", "src/repro/kernels/moe_decode/kernel.py:86"),
    "gather_swiglu": ("src/repro_torch/csrc/moe_fused.cu",
                      "src/repro/kernels/moe_fused/kernel.py:93"),
    "down_combine": ("src/repro_torch/csrc/moe_fused.cu",
                     "src/repro/kernels/moe_fused/kernel.py:175"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build_all

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    seconds = build_all()
    logs = sorted((ROOT / "build" / "repro_torch").glob("*.log"))
    ptxas = [ln.strip() for p in logs for ln in p.read_text().splitlines() if "Used" in ln or "spill" in ln]
    emit("build", seconds=seconds, ptxas=ptxas)

    cfg = get_config(ARCH)
    rows = kernel_phase(cfg, dev)
    torch.cuda.empty_cache()
    emit("kernels_vs_plain", **rows)

    emit("smoke_twin", **smoke_twin(dev))
    torch.cuda.empty_cache()

    served, rep = full_width(dev)
    emit("full_width", **served)
    emit("profile", **profile_decode(rep, cfg.vocab_size))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=served["kernel_launches"][name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
