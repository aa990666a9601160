#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the full-width
serving paths give it (and times both, beside the card's bound and one
PyTorch call where one computes the same function), serves the f32 smoke
twins on the card and on the CPU (greedy streams must be identical: chains,
a draft tree with the model drafter, the paged KV plane with trees and with
a shared prefix, and the hybrid RecurrentGemma stack over rolling windows),
then serves Qwen3-MoE-235B-A22B at full width, cut to 4 layers, on the
Agile decode plane twice: over the contiguous cache (spec 4, ngram drafter;
phase ``full_width``) and over the paged KV plane with a ``2,1`` draft tree
drafted by the target's first layer behind a 64-token shared system prompt
(phase ``paged_tree``); then through the expert-parallel MoE plane on a
one-rank (data 1, model 1) mesh over NCCL (phase ``expert_parallel``: the
a2a body with kernels 8-10 at admission, the shard-sliced decode plane,
logits held against the single-host model, the twin ``ep_spec4`` and a
profile); then on the quantized bandwidth plane, the same weights plus
their int8 expert twins over an int8 KV cache (phase ``int8_full_width``,
the int8 branches of kernels 1 and 2, and ``profile_int8``), and the same
prompt admitted twice through the bf16 and the int8 replica, bitwise
(``admit_twice``); then, with the MoE weights freed, RecurrentGemma-2B
uncut (26 layers, bf16) over 2,048-slot rolling windows with 2,048- to
4,096-token prompts (phase ``hybrid_window``), and again over int8 rolling
buffers (``int8_hybrid_window``, kernel 6's int8 branch); then, with those
weights freed, Mamba-2-2.7B uncut (64 SSD layers, bf16) on the same traffic
(phase ``ssm_serve``), and shows that each path ran its kernels.  The int8
branches are also held bitwise against their kernels on the dequantized
buffers (``kernels_vs_plain`` rows ``*_int8``), and the f32 smoke twins
serve int8 KV and experts too (``smoke_twin_int8``).  The redesigned rows
1, 2, 2q, 3, 4, 5, 6, 6q, 7, 8, 11 and 12 (the contiguous and paged decode
split over chunks, the decode MoE grouped by expert on the card and its
int8 branch, the window decode and its int8 branch, the tensor-core
builds of the gather + SwiGLU, the down projection + combine, the prefill,
the grouped GEMM and the SSD scan, and the RG-LRU scan chunked over T)
launch twice for a bitwise repeat and record registers and spills; 1, 2, 2q, 3, 4, 6, 6q, 7 and 8 time their
yardstick in turns with the kernel; 1 also times the wrapper's host time
and its parts and the T = 1 launch; 2, 2q, 3, 4, 7, 8, 11 and 12 record a
SASS instruction census of their builds (``HGMMA``, the int8 branch's
conversions), 4, 8, 11 and 12 which build each case takes, 2, 2q
and 11 their device time by launch, and 12 its device time at each of the
hybrid cell's prompt lengths with f32 and bf16 inputs.
Every replica serves its decode launches through the compiled launch (one
CUDA graph per shape, replayed; ``repro_torch/launch/steps.py``), so the
cells and the ``profile*`` phases time replayed graphs; phase
``compiled_launch`` holds, in each of the eight cells, the same launches
run eagerly and replayed from the same admitted state: bitwise-equal
logits and cache leaves, with both sides' ms per decode launch and idle
share, the capture seconds and the graph pool's bytes.
Request programs and the fabric (phases ``smoke_twin_programs``,
``programs``, ``forks``, ``fabric_crash``): the f32 smoke twins with a
JSON-schema program, a steered tree and a 2-way fork, card against CPU;
while the 4-layer Qwen3-MoE weights are resident, the README's JSON-schema
program and a literal token-id program served on the contiguous,
paged-tree and int8 paged-tree replicas beside their unconstrained runs (no
token outside its grammar, every stream a word of it, steered and
unsteered streams identical; the masked verify's cost on the card), then
fork 2 with join first and join all on the paged plane (no prompt row of a
full page copied); then Qwen3-MoE at full widths cut to 1 layer served
through ``ServeFabric`` twice, clean and with a crash at launch 3 and
checkpoints every 2 rounds (streams byte-identical; the dead replica
freed, the rebuilt one restored from the checkpoint, its graphs captured
again).
Each phase prints one JSON line; the full record also goes to
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
# the paged cell: a 64-token shared system prompt before each 64/96/128-token
# prompt, pages of 16 rows, the 4-node draft tree 2,1
SHARED, PAGE, TREE = 64, 16, (2, 1)
PAGED_MAX_LEN = PROMPT + SHARED + GEN + 4   # 228 rows, 15 pages a slot
# the hybrid cell: RecurrentGemma-2B uncut, 4 slots, 8 requests of
# 2,048/3,072/4,096 tokens (the CLI's buckets for --prompt-len 4096), 64
# generated tokens each, spec width 1, rolling windows of 2,048 slots
HYBRID = "recurrentgemma-2b"
H_SLOTS, H_PROMPT, H_GEN, H_REQUESTS = 4, 4096, 64, 8
H_MAX_LEN = H_PROMPT + H_GEN + 1            # 4,161 rows of slot budget
# the SSM cell: Mamba-2-2.7B uncut on the hybrid cell's traffic (the same
# slots, requests, prompt buckets, generated tokens and slot budget)
SSM = "mamba2-2.7b"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor rate, published
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores, published
# the times of the designs the redesigned kernels 1, 1q, 5, 5q, 6, 6q, 7, 8,
# 3, 11, 2, 2q, 4 and 12 replaced (one block per token, or per (batch, head),
# or one thread per channel, walking its whole run; f32 products on CUDA
# cores), at the same shapes on an H100 80GB HBM3 at 700 W (PERF.md, section
# 6; kernel 11's with bf16 x, B, C; kernel 12's with f32 gates and, as
# rglru_scan_bf16, bf16 ones)
PREVIOUS_MS = {"flash_decode_window": 2.0794, "flash_decode_window_int8": 1.8234, "flash_attention": 6.2515,
               "flash_decode": 0.1042, "flash_decode_int8": 0.1106, "flash_decode_paged": 0.1839,
               "flash_decode_paged_int8": 0.1775, "grouped_gemm": 1.0188, "gather_swiglu": 3.9923,
               "ssd_scan": 1.9367, "decode_moe": 2.2314, "decode_moe_int8": 2.8808, "down_combine": 3.0389,
               "rglru_scan": 0.2003, "rglru_scan_bf16": 1.393}
# and their device times where the profiler read them (kernels 1, 1q, 5, 5q, 8)
PREVIOUS_DEVICE_MS = {"flash_decode": 0.1003, "flash_decode_int8": 0.1073, "flash_decode_paged": 0.1805,
                      "flash_decode_paged_int8": 0.1712, "grouped_gemm": 1.0074}

RECORD: dict = {}
START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """Print one phase's record as a JSON line (with the script's seconds
    so far, ``script_s``) and keep it for ``chiprun_out/chip_smoke.json``."""
    fields["script_s"] = time.perf_counter() - START
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


def device_ms(fn, match: str, n: int = 20):
    """Mean device time per call of the kernels whose names contain
    ``match`` over ``n`` calls of ``fn``, from ``torch.profiler`` (None when
    it shows no device time): the kernel alone, where ``time_ms`` of a
    microsecond kernel measures how fast the host issues its wrapper."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA and match in ev.key)
    return us / 1e3 / n if us else None


def moe_decode_launches(fn) -> dict:
    """Device ms per call of kernel 2's three launches (the profiler's
    demangled names: gate/up's instantiations take 2 matrices, down's 1)."""
    return {"gate_up": device_ms(fn, ", 2, ", n=10), "down": device_ms(fn, ", 1, ", n=10),
            "combine": device_ms(fn, "combine_kernel", n=10)}


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
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


def check_composed(name, got, want, h_kernel, h_plain, w):
    """Hold for ``h' @ w`` against ``h @ w`` where h' and h are a kernel's
    and its plain version's bf16 intermediates (already held to one ulp of
    each other): an element of the product may differ by what the
    intermediates' difference carries through, ``|h' - h| @ |w|``, plus one
    ulp (2^-7 of its value) from the last rounding, plus the 1e-3 x rms
    floor of :func:`check_bf16`."""
    import torch

    g, wt = got.float(), want.float()
    err = (g - wt).abs()
    carried = torch.bmm((h_kernel.float() - h_plain.float()).abs(), w.float().abs())
    lim = 2.0 ** -7 * wt.abs() + carried + 1e-3 * float(wt.pow(2).mean().sqrt())
    bad = int((err > lim).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} of {err.numel()} elements differ by more than 2^-7 |plain| + "
                             f"|h' - h| @ |w| + 1e-3 rms (max |kernel - plain| {float(err.max()):.3e})")
    return float(err.max())


def in_turns(kernel, yardstick, iters: int, reps: int = 5):
    """Kernel and yardstick timed in turns (yardstick, kernel, kernel,
    yardstick; :func:`time_ms` each): (kernel ms, yardstick ms, the four
    times in that order), each ms the mean of its pair."""
    y1 = time_ms(yardstick, iters, reps)
    k1, k2 = time_ms(kernel, iters, reps), time_ms(kernel, iters, reps)
    y2 = time_ms(yardstick, iters, reps)
    return (k1 + k2) / 2, (y1 + y2) / 2, [y1, k1, k2, y2]


def ptxas(source: str, *names: str) -> dict:
    """Registers and spill bytes of each kernel of ``csrc/<source>.cu``
    whose mangled name holds one of ``names``, from the build's
    ``-Xptxas -v`` log (which shows no dynamic shared memory: a launch's
    request is reported beside it)."""
    from repro_torch.kernels import _lib_path

    found, name = {}, None
    for line in _lib_path(source).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and any(n in name for n in names):
            if "Used" in line and "registers" in line:
                found.setdefault(name, {})["registers"] = int(line.split("Used")[1].split()[0])
            elif "spill stores" in line:
                found.setdefault(name, {})["spill_store_bytes"] = int(line.split("bytes spill stores")[0].split(",")[-1])
    return found


CENSUS_OPS = ("HGMMA", "FFMA", "FMUL", "FADD", "I2F", "PRMT", "LDS", "LDG", "LDGSTS", "STG", "BAR")


def census_of(lib: Path, *names: str) -> dict:
    """Static SASS instruction counts (``cuobjdump -sass``) of each kernel of
    the built library ``lib`` whose mangled name holds one of ``names``:
    every instruction, and those of ``CENSUS_OPS`` by opcode (suffixes
    dropped)."""
    from repro_torch.kernels import _nvcc

    run = subprocess.run([str(Path(_nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300)
    found, name = {}, None
    for ln in run.stdout.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            name = name if any(n in name for n in names) else None
            continue
        parts = ln.split("*/", 1)
        if name is None or not parts[0].strip().startswith("/*") or len(parts) < 2 or not parts[1].strip():
            continue
        words = parts[1].split()
        op = (words[1] if words[0].startswith("@") else words[0]).split(".")[0].rstrip(";")
        counts = found.setdefault(name, {"all": 0})
        counts["all"] += 1
        if op in CENSUS_OPS:
            counts[op] = counts.get(op, 0) + 1
    return found


def sass_census(source: str, *names: str) -> dict:
    """:func:`census_of` the built library of ``csrc/<source>.cu``."""
    from repro_torch.kernels import _lib_path

    return census_of(_lib_path(source), *names)


# kernel 2's builds at the serving shape (16-byte copies): gate/up (2
# matrices) with bf16 x over bf16 or int8 stacks, and down (1 matrix, f32 h)
MOE_DECODE_BF16 = ("expert_kernelI13__nv_bfloat16S1_Li2ELb1E", "expert_kernelIf13__nv_bfloat16Li1ELb1E")
MOE_DECODE_INT8 = ("expert_kernelI13__nv_bfloat16aLi2ELb1E", "expert_kernelIfaLi1ELb1E")


def host_ms(fn, n: int = 200) -> float:
    """Host time per call of ``fn``: the wall time of ``n`` calls issued back
    to back without synchronising, over ``n``.  Where a call's device work
    is shorter than its issue the card waits on the host, and this is what
    ``time_ms`` of back-to-back calls measures."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e3


# the bf16 instantiations of kernels 1 and 5 at hd 128 (contiguous Li0,
# paged Li1) in the build log
DECODE_PTXAS = "decode_split_kernelI13__nv_bfloat16S1_Li128ELi0EE"
PAGED_PTXAS = "decode_split_kernelI13__nv_bfloat16S1_Li128ELi1EE"


def bitwise_repeat(name, fn):
    """Launch ``fn`` twice on the same inputs; raise unless bitwise equal."""
    import torch

    a, b = fn(), fn()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: a repeated launch is not bitwise equal")
    return True


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at full-width shapes
# ---------------------------------------------------------------------------


def _sdpa_decode(q, k, v, mask):
    """SDPA over the cache with kv heads expanded beforehand (set-up): the
    one PyTorch call that computes kernel 1's function."""
    import torch

    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (c.transpose(1, 2).repeat_interleave(G, 1) for c in (k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def _last_token(q, lengths):
    """(q, lengths, chain word) of each slot's last token alone (T = 1)."""
    import torch

    B, T = q.shape[:2]
    return (q[:, -1:].contiguous(), lengths.reshape(B, T)[:, -1].contiguous(),
            torch.full((1,), -1, dtype=torch.int32, device=q.device))


def decode_t1(q, k, v, lengths, base, mask):
    """Row 1 at T = 1: each slot's last chain token alone, 16 (kv head,
    slot) pairs, each split over the capacity's chunks.  Held
    against the plain version; the kernel and SDPA timed in turns, and
    both device times."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, T = q.shape[:2]
    q1, l1, chain1 = _last_token(q, lengths)

    def kernel():
        return fa_ops.flash_decode_kernel(q1, k, v, l1, chain1, base)

    err = check_bf16("flash_decode bf16 T=1", kernel(), fa_ref.flash_decode(q1, k, v, l1, chain1, base))
    lib = _sdpa_decode(q1, k, v, mask[:, :, -1:])
    ms, lib_ms, turns = in_turns(kernel, lib, iters=50)
    return dict(max_abs_err=err, ms=ms, library_ms=lib_ms, ms_in_turns=turns, device_ms=device_ms(kernel, ""),
                library_device_ms=device_ms(lib, ""), host_ms=host_ms(kernel), lengths=l1.tolist())


def decode_host_parts(q, k, v, lengths, chain, base):
    """The pieces of the flash-decode wrapper's host time at row 1's shape
    (``host_ms`` each): the C entry alone, called through the wrapper's own
    ``function`` with its arguments built beforehand (the split launch and
    the merge launch), the two allocations a call makes, and the stream
    handle the wrapper reads against the ``torch.cuda.Stream`` it replaced."""
    import math

    import torch

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    nsplit = fa_ops.decode_splits(S)
    out = torch.empty_like(q)
    part = torch.empty((B * T * nq * nsplit * (hd + 2),), dtype=torch.float32, device=q.device)
    fn = kernels.function("flash_decode", "repro_flash_decode", fa_ops._DECODE_ARGTYPES[0])
    argv = (kernels.dtype_code(q.dtype), kernels.dtype_code(k.dtype), *(t.data_ptr() for t in (q, k, v)), None, None,
            *(t.data_ptr() for t in (out, part, lengths, chain, base)), B, T, S, nq, nkv, hd, 1.0 / math.sqrt(hd),
            nsplit, kernels.stream_of(q))

    def launch():
        if fn(*argv) != 0:
            raise RuntimeError("repro_flash_decode refused row 1's launch")

    return {"c_entry_alone": host_ms(launch),
            "empty_like_q_and_part": host_ms(lambda: (torch.empty_like(q), torch.empty(part.shape, dtype=part.dtype,
                                                                                      device=part.device))),
            "raw_stream_handle": host_ms(lambda: kernels.stream_of(q)),
            "torch_cuda_current_stream": host_ms(lambda: torch.cuda.current_stream(q.device).cuda_stream)}


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
    lib = _sdpa_decode(q, kk, vv, mask)

    L = lengths.reshape(B, T).long()
    kv_rows = int(L.max(dim=1).values.sum())
    nbytes = 2 * q.numel() * 2 + kv_rows * nkv * hd * 2 * 2 + (B * T + T + B) * 4
    flops = float(L.sum()) * nq * hd * 4

    def kernel_decode():
        return fa_ops.flash_decode_kernel(q, kk, vv, lengths, chain, base)

    ms, lib_ms, turns = in_turns(kernel_decode, lib, iters=50)
    rows["flash_decode"] = dict(
        max_abs_err=err, max_abs_err_f32=err32,
        ms=ms, plain_ms=time_ms(lambda: fa_ref.flash_decode(q, kk, vv, lengths, chain, base)),
        library_ms=lib_ms, ms_in_turns=turns,
        library_call="scaled_dot_product_attention (boolean mask, kv heads expanded beforehand)",
        # device times: every kernel one call launches, from the profiler
        device_ms=device_ms(kernel_decode, ""), library_device_ms=device_ms(lib, ""),
        host_ms=host_ms(kernel_decode), library_host_ms=host_ms(lib),
        bitwise_repeat=bitwise_repeat("flash_decode", kernel_decode), previous_ms=PREVIOUS_MS["flash_decode"],
        previous_device_ms=PREVIOUS_DEVICE_MS["flash_decode"],
        design=f"{fa_ops.decode_splits(max_len)} splits of {fa_ops.DECODE_CHUNK} rows x {nkv * T * B} (kv head, "
               f"token, slot) = {fa_ops.decode_splits(max_len) * nkv * T * B} blocks, then a merge launch of "
               f"{nq * T * B} blocks",
        ptxas=ptxas("flash_decode", DECODE_PTXAS, "window_merge_kernelI13__nv_bfloat16Li128E"),
        t1=decode_t1(q, kk, vv, lengths, base, mask), host_parts_ms=decode_host_parts(q, kk, vv, lengths, chain, base),
        shapes=f"q {tuple(q.shape)}, kv {tuple(kk.shape)}, lengths {lengths.tolist()}",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    del q32, k32, v32, q, kk, vv, lib

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

    def kernel_moe():
        return md_ops.decode_moe_kernel(x, ids, w, wg, wu, wd)

    ms, comp_ms, turns = in_turns(kernel_moe, composite_decode, iters=10)
    rows["decode_moe"] = dict(
        max_abs_err=err, max_abs_err_f32=err32,
        ms=ms, composite_ms=comp_ms, ms_in_turns=turns,
        composite_call="gather of the named experts' stacks + torch.bmm x3 (in turns)",
        device_ms=device_ms(kernel_moe, "", n=10), device_ms_by_launch=moe_decode_launches(kernel_moe),
        plain_ms=time_ms(lambda: md_ref.decode_moe(x, ids, w, wg, wu, wd), iters=3, reps=3),
        library_ms=None, library_call=None,
        bitwise_repeat=bitwise_repeat("decode_moe", kernel_moe), previous_ms=PREVIOUS_MS["decode_moe"],
        ptxas=ptxas("moe_decode", *MOE_DECODE_BF16), sass=sass_census("moe_decode", *MOE_DECODE_BF16),
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

    def kernel_gather():
        return mf_ops.gather_swiglu(xp, idx, wg, wu)

    ms, comp_ms, turns = in_turns(kernel_gather, composite_gather, iters=10)
    rows["gather_swiglu"] = dict(
        max_abs_err=err_g, max_abs_err_f32=err_g32,
        ms=ms, composite_ms=comp_ms, ms_in_turns=turns, composite_call="index gather + torch.bmm x2 (in turns)",
        device_ms=device_ms(kernel_gather, "gather_swiglu", n=10),
        plain_ms=time_ms(lambda: mf_ref.gather_swiglu(xp, idx, wg, wu), iters=3, reps=3),
        library_ms=None, library_call=None,
        bitwise_repeat=bitwise_repeat("gather_swiglu", kernel_gather), previous_ms=PREVIOUS_MS["gather_swiglu"],
        path=mf_ops.gather_swiglu_path(xp.dtype, d, f, True),
        ptxas=ptxas("moe_fused", "gather_swiglu_tc"), sass=sass_census("moe_fused", "gather_swiglu_tc"),
        shapes=shapes, bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    nbytes = used * f * d * 2 + n_occ * f * 2 + E * C * 8 + Tp * d * 4
    flops = n_occ * 2.0 * f * d

    def kernel_down():
        return mf_ops.down_combine(h, wd, idx, sw, Tp)

    ms, comp_ms, turns = in_turns(kernel_down, composite_down, iters=10)
    rows["down_combine"] = dict(
        max_abs_err=err_d, max_abs_err_f32=err_d32,
        ms=ms, composite_ms=comp_ms, ms_in_turns=turns, composite_call="torch.bmm + index_add_ (in turns)",
        device_ms=device_ms(kernel_down, "", n=10),
        plain_ms=time_ms(lambda: mf_ref.down_combine(h, wd, idx, sw, Tp), iters=3, reps=3),
        library_ms=None, library_call=None,
        bitwise_repeat=bitwise_repeat("down_combine", kernel_down), previous_ms=PREVIOUS_MS["down_combine"],
        path=mf_ops.down_combine_path(h.dtype, f, d, True),
        ptxas=ptxas("moe_fused", "down_rows_tc"), sass=sass_census("moe_fused", "down_rows_tc"),
        shapes=shapes, bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    rows.update(ep_kernel_rows(dev, gen, tol, xp, pplan, h, wg, wu, wd))
    del wg, wu, wd, h
    torch.cuda.empty_cache()
    rows["flash_decode_paged"] = paged_kernel_rows(cfg, dev, gen, tol)
    rows.update(hybrid_kernel_rows(dev, gen, tol))
    rows["ssd_scan"] = ssd_kernel_row(dev, gen, tol)
    rows.update(int8_kernel_rows(cfg, dev, gen, tol))
    return rows


def ep_kernel_rows(dev, gen, tol, xp, plan, h, wg, wu, wd):
    """Kernels 8-10 at the a2a body's shapes for one 128-token admission
    prompt (E 128, top-8, C 16, d 4096, f 1536, bf16): dispatch of the
    prompt into the plan's slots (held exactly), the combine of (E, C, d)
    expert outputs (one bf16 ulp; f32 at 1e-4), the grouped down projection
    of h (E, C, f) through w_down (one bf16 ulp; f32 at 1e-4); and each at a
    ragged shape: T 37, d 100 (not a whole number of 16-byte vectors), C 5
    (dropped assignments and empty slots), and the GEMM at E 3, M 37, K 100,
    N 130.  Then the a2a body's expert step as it runs there: kernel 3 over
    the 2,048 dispatched slot rows with the identity index (one bf16 ulp),
    and the whole ``fused_experts_fn`` (kernel 3, then kernel 8): one bf16
    ulp against the plain GEMM on kernel 3's output, and against the plain
    composition within :func:`check_composed`."""
    import torch

    from repro_torch.core.control_plane import route_topk
    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.kernels.grouped_gemm import ref as gg_ref
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_dispatch import ref as md_ref

    bf16 = torch.bfloat16
    E, C = plan.num_experts, plan.capacity
    T, k = plan.combine_idx.shape
    d = xp.shape[1]
    rows = {}

    def exact(name, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"(max |diff| {float((got.float() - want.float()).abs().max()):.3e})")
        return 0.0

    # ---- ragged cases: drops, empty slots, scalar rows, ragged GEMM tiles
    xr = torch.randn((37, 100), generator=gen, device=dev)
    wr = torch.randn((100, 8), generator=gen, device=dev) * 0.3
    xr[:, 0], wr[0, :2] = 4.0, 2.0  # experts 0 and 1 win: they overflow, the rest stay short
    rplan, _ = route_topk(xr, wr, 2, 5)
    drops, empty = int((rplan.combine_idx < 0).sum()), int((~rplan.dispatch_valid).sum())
    if not (drops and empty):
        raise AssertionError(f"ragged dispatch case: {drops} dropped assignments, {empty} empty slots")
    yr = torch.randn((8, 5, 100), generator=gen, device=dev)
    ga, gb = (torch.randn(s, generator=gen, device=dev) for s in ((3, 37, 100), (3, 100, 130)))
    for dt in (torch.float32, bf16):
        exact(f"moe_dispatch ragged {dt}", md_ops.dispatch(xr.to(dt), rplan), md_ref.dispatch(xr.to(dt), rplan))
        got, want = md_ops.combine(yr.to(dt), rplan), md_ref.combine(yr.to(dt), rplan)
        check_close(f"moe_combine ragged {dt}", got, want, tol["f32"]) if dt == torch.float32 else \
            check_bf16("moe_combine ragged bf16", got, want)
        got, want = gg_ops.grouped_gemm(ga.to(dt), gb.to(dt)), gg_ref.grouped_gemm(ga.to(dt), gb.to(dt))
        check_close(f"grouped_gemm ragged {dt}", got, want, tol["f32"]) if dt == torch.float32 else \
            check_bf16("grouped_gemm ragged bf16", got, want)
    ragged = (f"ragged: x (37, 100), E 8, top-2, C 5 ({drops} dropped assignments, {empty} empty slots); "
              f"GEMM (3, 37, 100) @ (3, 100, 130)")
    # which build of kernel 8 each case takes
    gemm_paths = {f"{tag} {dt}": gg_ops.grouped_gemm_path(dt, K_, N_, True) for tag, K_, N_ in
                  (("ragged (3, 37, 100) @ (3, 100, 130)", 100, 130), ("row 8", h.shape[2], wd.shape[2]))
                  for dt in (torch.float32, bf16)}

    # ---- moe_dispatch: the 128-token prompt into (128, 16, 4096) slots
    err32 = exact("moe_dispatch f32", md_ops.dispatch(xp.float(), plan), md_ref.dispatch(xp.float(), plan))
    err = exact("moe_dispatch bf16", md_ops.dispatch(xp, plan), md_ref.dispatch(xp, plan))
    x_pad = torch.cat([xp, xp.new_zeros((1, d))])  # set-up: the library call needs the zero row
    idx = plan.flat_dispatch_idx().long()
    occupied = int((idx < T).sum())
    nbytes = E * C * d * 2 + len(set(idx[idx < T].tolist())) * d * 2 + E * C * 4
    rows["moe_dispatch"] = dict(
        max_abs_err=err, max_abs_err_f32=err32, exact=True,
        ms=time_ms(lambda: md_ops.dispatch(xp, plan), iters=50),
        device_ms=device_ms(lambda: md_ops.dispatch(xp, plan), "dispatch_kernel"),
        plain_ms=time_ms(lambda: md_ref.dispatch(xp, plan), iters=20),
        library_ms=time_ms(lambda: torch.index_select(x_pad, 0, idx), iters=50),
        library_call="torch.index_select(x_pad, 0, idx) (the zero row appended beforehand)",
        shapes=f"x {tuple(xp.shape)} -> slots ({E}, {C}, {d}), {occupied} slots occupied; {ragged}",
        bytes=nbytes, flops=0.0, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 0.0))),
    )

    # ---- moe_combine: (128, 16, 4096) expert outputs back into 128 tokens
    y_slots = torch.randn((E, C, d), generator=gen, device=dev)
    err32 = check_close("moe_combine f32", md_ops.combine(y_slots, plan), md_ref.combine(y_slots, plan), tol["f32"])
    y_slots = y_slots.to(bf16)
    err = check_bf16("moe_combine bf16", md_ops.combine(y_slots, plan), md_ref.combine(y_slots, plan))
    cidx, cw = plan.flat_combine_words()
    y_pad = torch.cat([y_slots.reshape(E * C, d), y_slots.new_zeros((1, d))])  # set-up
    cl, wk = cidx.long(), cw.reshape(T, k, 1)

    def composite():
        return (torch.index_select(y_pad, 0, cl).reshape(T, k, d).float() * wk).sum(1).to(bf16)

    kept = int((cidx < E * C).sum())
    nbytes = kept * d * 2 + T * d * 2 + T * k * 8
    flops = 2.0 * kept * d
    rows["moe_combine"] = dict(
        max_abs_err=err, max_abs_err_f32=err32,
        ms=time_ms(lambda: md_ops.combine(y_slots, plan), iters=50),
        device_ms=device_ms(lambda: md_ops.combine(y_slots, plan), "combine_kernel"),
        plain_ms=time_ms(lambda: md_ref.combine(y_slots, plan), iters=20),
        library_ms=None, library_call=None,
        composite_ms=time_ms(composite, iters=20),
        composite_call="index_select of the assignments' slot rows + f32 weighted sum over top-k",
        shapes=f"slots ({E}, {C}, {d}) -> ({T}, {d}), top-{k}, {T * k - kept} dropped assignments; {ragged}",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    del y_slots, y_pad, x_pad

    # ---- grouped_gemm: the a2a down projection h (128, 16, 1536) @ w_down
    err = check_bf16("grouped_gemm bf16", gg_ops.grouped_gemm(h, wd), gg_ref.grouped_gemm(h, wd))
    h32, wd32 = h.float(), wd.float()
    err32 = check_close("grouped_gemm f32", gg_ops.grouped_gemm(h32, wd32), gg_ref.grouped_gemm(h32, wd32),
                        tol["f32"])
    del h32, wd32
    torch.cuda.empty_cache()
    Eh, M, K = h.shape
    N = wd.shape[2]
    nbytes = (h.numel() + wd.numel() + Eh * M * N) * 2
    flops = 2.0 * Eh * M * K * N

    def kernel_gemm():
        return gg_ops.grouped_gemm(h, wd)

    ms, lib_ms, turns = in_turns(kernel_gemm, lambda: torch.bmm(h, wd), iters=10)
    rows["grouped_gemm"] = dict(
        max_abs_err=err, max_abs_err_f32=err32,
        ms=ms, library_ms=lib_ms, ms_in_turns=turns, library_call="torch.bmm (bf16)",
        device_ms=device_ms(kernel_gemm, "grouped_gemm", n=10),
        library_device_ms=device_ms(lambda: torch.bmm(h, wd), "", n=10),
        plain_ms=time_ms(lambda: gg_ref.grouped_gemm(h, wd), iters=3, reps=3),
        bitwise_repeat=bitwise_repeat("grouped_gemm", kernel_gemm), previous_ms=PREVIOUS_MS["grouped_gemm"],
        previous_device_ms=PREVIOUS_DEVICE_MS["grouped_gemm"],
        paths=gemm_paths, ptxas=ptxas("grouped_gemm", "grouped_gemm"), sass=sass_census("grouped_gemm", "grouped_gemm"),
        shapes=f"h {tuple(h.shape)} @ w_down {tuple(wd.shape)}; {ragged}",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )

    # ---- the a2a body's expert step: kernel 3 over the dispatched slots
    # (identity index, every slot a row of its own), then kernel 8
    from repro_torch.kernels.moe_fused import ops as mf_ops
    from repro_torch.kernels.moe_fused import ref as mf_ref

    slots = md_ops.dispatch(xp, plan)
    flat = slots.reshape(E * C, d)
    ident = torch.arange(E * C, dtype=torch.int32, device=dev)
    h_a2a = mf_ops.gather_swiglu(flat, ident, wg, wu)
    h_plain = mf_ref.gather_swiglu(flat, ident, wg, wu)
    err_g = check_bf16("gather_swiglu a2a bf16", h_a2a, h_plain)
    p = {"w_gate": wg, "w_up": wu, "w_down": wd}
    got = mf_ops.fused_experts_fn(slots, p)
    # kernel 8 on kernel 3's own output: one ulp; against the plain
    # composition end to end: what kernel 3's ulps carry, plus one ulp
    err_f = check_bf16("fused_experts_fn bf16", got, gg_ref.grouped_gemm(h_a2a, wd))
    err_c = check_composed("fused_experts_fn vs plain composition", got, gg_ref.grouped_gemm(h_plain, wd),
                           h_a2a, h_plain, wd)
    rows["fused_experts_fn"] = dict(
        gather_swiglu_max_abs_err=err_g, max_abs_err=err_f, max_abs_err_vs_plain_composition=err_c,
        tolerance="kernel 3 and kernel 8 on kernel 3's output: one bf16 ulp (check_bf16); "
                  "end to end: check_composed",
        ms=time_ms(lambda: mf_ops.fused_experts_fn(slots, p), iters=5),
        plain_ms=time_ms(lambda: gg_ref.grouped_gemm(mf_ref.gather_swiglu(flat, ident, wg, wu), wd),
                         iters=2, reps=3),
        shapes=f"slots ({E}, {C}, {d}) from the prompt's dispatch, identity index over {E * C} rows, "
               f"w_gate/w_up ({E}, {d}, {wg.shape[2]}), w_down {tuple(wd.shape)}",
    )
    del slots, flat, h_a2a, h_plain, got
    torch.cuda.empty_cache()
    return rows


def _paged_case(dev):
    """The paged cell's kernel-5 case: 4 slots x the 4 nodes of tree 2,1
    over a pool of 60 pages x 16 rows, committed lengths 16 tokens into
    generation of the 128/160/192/128-token prompts, and a fixed scrambled
    table whose first 4 pages (the shared system prompt) are every slot's:
    (B, T, ps, mp, n_pages, base list, base, lengths, words, table (numpy),
    table (flat, on ``dev``))."""
    import numpy as np
    import torch

    from repro_torch.core.plans import TreePlan

    tree = TreePlan.from_branching(TREE)
    B, T, ps = SLOTS, tree.num_nodes, PAGE
    mp = -(-PAGED_MAX_LEN // ps)
    n_pages = B * mp
    base_l = [SHARED + n + 16 for n in (64, 96, 128, 64)]
    base = torch.tensor(base_l, dtype=torch.int32, device=dev)
    lengths = (base[:, None] + torch.arange(1, T + 1, dtype=torch.int32, device=dev)).reshape(-1).contiguous()
    words = torch.tensor(tree.ancestor_words(), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(12)
    n_shared = SHARED // ps
    private = rng.permutation(np.arange(n_shared, n_pages))
    table_np = np.full((B, mp), -1, np.int32)
    used = 0
    for b, L in enumerate(base_l):
        need = -(-(L + T) // ps)
        table_np[b, :n_shared] = np.arange(n_shared)
        table_np[b, n_shared:need] = private[used:used + need - n_shared]
        used += need - n_shared
    table = torch.from_numpy(table_np).reshape(-1).to(dev)
    return B, T, ps, mp, n_pages, base_l, base, lengths, words, table_np, table


def paged_kernel_rows(cfg, dev, gen, tol):
    """flash_decode_paged at the paged cell's shapes: 4 slots x the 4 nodes
    of tree 2,1 over a pool of 60 pages x 16 rows, through a fixed scrambled
    table whose first 4 pages (the shared system prompt) are the same for
    every slot; then the identity table against the contiguous kernel."""
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    bf16 = torch.bfloat16
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, T, ps, mp, n_pages, base_l, base, lengths, words, table_np, table = _paged_case(dev)
    q32 = torch.randn((B, T, nq, hd), generator=gen, device=dev)
    pk32 = torch.randn((n_pages * ps, nkv, hd), generator=gen, device=dev)
    pv32 = torch.randn((n_pages * ps, nkv, hd), generator=gen, device=dev)

    def run(q, pk, pv, tbl, w=words, bs=base):
        return fa_ops.flash_decode_paged_kernel(q, pk, pv, lengths, tbl, w, bs, page_size=ps)

    err32 = check_close("flash_decode_paged f32", run(q32, pk32, pv32, table),
                        fa_ref.flash_decode_paged(q32, pk32, pv32, lengths, table, words, base, ps), tol["f32"])
    q, pk, pv = q32.to(bf16), pk32.to(bf16), pv32.to(bf16)
    err = check_bf16("flash_decode_paged bf16", run(q, pk, pv, table),
                     fa_ref.flash_decode_paged(q, pk, pv, lengths, table, words, base, ps))
    # identity table: bitwise the contiguous kernel, tree and chain words, both types
    ident = torch.arange(n_pages, dtype=torch.int32, device=dev)
    for qq, kk, vv in ((q32, pk32, pv32), (q, pk, pv)):
        kc, vc = kk.view(B, mp * ps, nkv, hd), vv.view(B, mp * ps, nkv, hd)
        for w, bs in ((words, base), (None, None)):
            if not torch.equal(run(qq, kk, vv, ident, w, bs), fa_ops.flash_decode_kernel(qq, kc, vc, lengths, w, bs)):
                raise AssertionError(f"flash_decode_paged {qq.dtype}: identity table is not bitwise the "
                                     f"contiguous kernel (words {'tree' if w is not None else 'chain'})")
    # the contiguous kernel on the same rows (the pool viewed as 4 stripes):
    # what the paged row-address policy costs at these shapes
    kc, vc = pk.view(B, mp * ps, nkv, hd), pv.view(B, mp * ps, nkv, hd)
    contiguous_ms = time_ms(lambda: fa_ops.flash_decode_kernel(q, kc, vc, lengths, words, base), iters=50)
    S = mp * ps
    vis = fa_ref.visible_rows(lengths, words, base, B, T, S)[:, None]  # (B, 1, T, S)
    qt = q.transpose(1, 2)
    pages = table.reshape(B, mp).long().clamp(min=0)
    gather_rows = ((pages * ps)[:, :, None] + torch.arange(ps, device=dev)).reshape(B, S)

    def composite():
        kt, vt = (c[gather_rows].transpose(1, 2).repeat_interleave(nq // nkv, 1) for c in (pk, pv))
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis)

    # bytes: each distinct K/V row the tokens' prefixes touch (the shared
    # pages once), q in, out, and the control words
    Lmax = lengths.reshape(B, T).max(dim=1).values.tolist()
    rows_touched = {(int(table_np[b, p // ps]), p % ps) for b in range(B) for p in range(Lmax[b])}
    nbytes = 2 * q.numel() * 2 + len(rows_touched) * nkv * hd * 2 * 2 + (B * T + B * mp + T + B) * 4
    flops = float(vis.sum()) * nq * hd * 4
    return dict(
        max_abs_err=err, max_abs_err_f32=err32, identity_table_bitwise=True,
        ms=time_ms(lambda: run(q, pk, pv, table), iters=50),
        device_ms=device_ms(lambda: run(q, pk, pv, table), ""), host_ms=host_ms(lambda: run(q, pk, pv, table)),
        bitwise_repeat=bitwise_repeat("flash_decode_paged", lambda: run(q, pk, pv, table)),
        previous_ms=PREVIOUS_MS["flash_decode_paged"], previous_device_ms=PREVIOUS_DEVICE_MS["flash_decode_paged"],
        ptxas=ptxas("flash_decode", PAGED_PTXAS),
        plain_ms=time_ms(lambda: fa_ref.flash_decode_paged(q, pk, pv, lengths, table, words, base, ps)),
        library_ms=None, library_call=None, contiguous_kernel_ms=contiguous_ms,
        composite_ms=time_ms(composite, iters=50),
        composite_call="gather through the block table + scaled_dot_product_attention (boolean mask, "
                       "kv heads expanded)",
        shapes=f"q {tuple(q.shape)}, pool {tuple(pk.shape)} ({n_pages} pages of {ps}), base {base_l}, "
               f"tree {TREE}, {len(rows_touched)} distinct rows read",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )


def hybrid_kernel_rows(dev, gen, tol):
    """Kernels 6, 7 and 12 at the hybrid cell's shapes (RecurrentGemma-2B:
    10 query heads over one KV head, hd 256, window 2,048, lru width 2,560),
    f32 and bf16, each against its plain version; kernel 6 also as a T = 3
    chain at a small shape, kernel 7 also at Qwen3-MoE's prefill shape."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    hcfg, qcfg = get_config(HYBRID), get_config(ARCH)
    bf16 = torch.bfloat16
    nq, nkv, hd, W = hcfg.num_heads, hcfg.num_kv_heads, hcfg.resolved_head_dim, hcfg.local_window
    G = nq // nkv
    chunk = fa_ops.WINDOW_CHUNK
    rows = {}

    # ---- flash_decode_window: 4 slots, one token each, every window wrapped
    def window_check(B, T, nq_, nkv_, hd_, W_, window, idx, tag):
        pos = (torch.tensor(idx, dtype=torch.int32)[:, None] + torch.arange(T, dtype=torch.int32)).reshape(-1)
        pos = pos.to(dev)
        q32 = torch.randn((B, T, nq_, hd_), generator=gen, device=dev)
        k32, v32 = (torch.randn((B, W_, nkv_, hd_), generator=gen, device=dev) for _ in range(2))
        lim = min(window, W_)
        e32 = check_close(f"flash_decode_window f32 {tag}", fa_ops.flash_decode_window_kernel(
            q32, k32, v32, pos, window=window), fa_ref.flash_decode_window(q32, k32, v32, pos, lim), tol["f32"])
        q, kk, vv = q32.to(bf16), k32.to(bf16), v32.to(bf16)
        e = check_bf16(f"flash_decode_window bf16 {tag}", fa_ops.flash_decode_window_kernel(
            q, kk, vv, pos, window=window), fa_ref.flash_decode_window(q, kk, vv, pos, lim))
        return e, e32, (q, kk, vv, pos, lim)

    chain_err, chain_err32, _ = window_check(3, 3, 4, 2, 64, 24, 16, [2, 21, 75], "T=3 chain")
    idx = [2100, 2900, 3600, 4160]
    err, err32, (q, kk, vv, pos, lim) = window_check(H_SLOTS, 1, nq, nkv, hd, W, W, idx, "full width")
    B, T = H_SLOTS, 1
    # the window gathered into position order is set-up: one call attends over it
    p_all = pos.long()[:, None] - lim + 1 + torch.arange(lim, device=dev)[None, :]  # (B, lim), T = 1
    slots = torch.remainder(p_all.clamp(min=0), W)
    bidx = torch.arange(B, device=dev)[:, None]
    kt, vt = (c[bidx, slots].transpose(1, 2).repeat_interleave(G, 1) for c in (kk, vv))
    vis = (p_all >= 0)[:, None, None, :]
    qt = q.transpose(1, 2)

    def lib_window():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis)

    n_vis = [min(lim, p + 1) for p in idx]
    nbytes = 2 * q.numel() * 2 + sum(n_vis) * nkv * hd * 2 * 2 + B * T * 4
    flops = float(sum(n_vis)) * nq * hd * 4

    def kernel_window():
        return fa_ops.flash_decode_window_kernel(q, kk, vv, pos, window=W)

    ms, lib_ms, turns = in_turns(kernel_window, lib_window, iters=20)
    rows["flash_decode_window"] = dict(
        max_abs_err=err, max_abs_err_f32=err32, chain_t3_max_abs_err=chain_err, chain_t3_max_abs_err_f32=chain_err32,
        ms=ms, plain_ms=time_ms(lambda: fa_ref.flash_decode_window(q, kk, vv, pos, lim), iters=5, reps=3),
        library_ms=lib_ms, ms_in_turns=turns, device_ms=device_ms(kernel_window, "window_"),
        library_call="scaled_dot_product_attention over the window gathered into position order (boolean mask, "
                     "kv heads expanded beforehand)",
        previous_ms=PREVIOUS_MS["flash_decode_window"], bitwise_repeat=bitwise_repeat("flash_decode_window",
                                                                                      kernel_window),
        design=f"split over chunks of {chunk} rows ({fa_ops.window_splits(lim)} splits x {B} slots = "
               f"{fa_ops.window_splits(lim) * B} blocks), cp.async 16-byte row copies, warp-per-row scores with "
               f"one 16-head reduce-scatter; fixed-order merge launch",
        chunk=chunk,
        ptxas=ptxas("flash_decode", "window_split_kernelI13__nv_bfloat16S1_Li256EE",
                    "window_merge_kernelI13__nv_bfloat16Li256E"),
        # the split launch's request, computed here from split_smem's layout
        # (K, V tiles; probability rows of 20; two scale columns), not read from the build
        dynamic_smem_bytes_computed=2 * chunk * hd * 2 + 4 * (chunk * 20 + 2 * chunk),
        shapes=f"q {tuple(q.shape)}, rolling kv {tuple(kk.shape)}, positions {idx}, window {W}; "
               f"chain: q (3, 3, 4, 64) over (3, 24, 2, 64), window 16, positions from 2/21/75",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    del q, kk, vv, kt, vt, qt
    torch.cuda.empty_cache()

    # ---- flash_attention: one 4,096-token RecurrentGemma prompt, window 2,048
    def prefill_inputs(S, nq_, nkv_, hd_):
        q32 = torch.randn((1, S, nq_, hd_), generator=gen, device=dev)
        return q32, *(torch.randn((1, S, nkv_, hd_), generator=gen, device=dev) for _ in range(2))

    def prefill_check(qkv32, window, tag):
        q32, k32, v32 = qkv32
        e32 = check_close(f"flash_attention f32 {tag}",
                          fa_ops.flash_attention_kernel(q32, k32, v32, causal=True, window=window),
                          fa_ref.flash_attention(q32, k32, v32, causal=True, window=window), tol["f32"])
        q, k, v = (t.to(bf16) for t in qkv32)
        e = check_bf16(f"flash_attention bf16 {tag}", fa_ops.flash_attention_kernel(q, k, v, causal=True,
                                                                                    window=window),
                       fa_ref.flash_attention(q, k, v, causal=True, window=window))
        return e, e32, (q, k, v)

    q_err, q_err32, (q, k, v) = prefill_check(
        prefill_inputs(128, qcfg.num_heads, qcfg.num_kv_heads, qcfg.resolved_head_dim), 0, "qwen3-moe prompt")
    qwen_ms = time_ms(lambda: fa_ops.flash_attention_kernel(q, k, v, causal=True), iters=20)
    qwen_device_ms = device_ms(lambda: fa_ops.flash_attention_kernel(q, k, v, causal=True), "flash_attention_tc")
    q_repeat = bitwise_repeat("flash_attention qwen3-moe", lambda: fa_ops.flash_attention_kernel(q, k, v, causal=True))
    S = H_PROMPT
    err, err32, (q, k, v) = prefill_check(prefill_inputs(S, nq, nkv, hd), W, "recurrentgemma prompt")
    i = torch.arange(S, device=dev)
    band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < W)
    kt, vt = (c.transpose(1, 2).repeat_interleave(G, 1) for c in (k, v))
    qt = q.transpose(1, 2)

    def lib_prefill():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)

    pairs = sum(min(t + 1, W) for t in range(S))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    flops = float(pairs) * nq * hd * 4

    def kernel_prefill():
        return fa_ops.flash_attention_kernel(q, k, v, causal=True, window=W)

    ms, lib_ms, turns = in_turns(kernel_prefill, lib_prefill, iters=5, reps=3)
    rows["flash_attention"] = dict(
        max_abs_err=err, max_abs_err_f32=err32,
        ms=ms, plain_ms=time_ms(lambda: fa_ref.flash_attention(q, k, v, causal=True, window=W), iters=2, reps=3),
        library_ms=lib_ms, ms_in_turns=turns,
        library_call="scaled_dot_product_attention with a banded boolean mask (kv heads expanded beforehand)",
        qwen_prefill_ms=qwen_ms, qwen_prefill_device_ms=qwen_device_ms, qwen_max_abs_err=q_err,
        qwen_max_abs_err_f32=q_err32, device_ms=device_ms(kernel_prefill, "flash_attention_tc", n=5),
        path=fa_ops.flash_attention_path(q.dtype, hd), previous_ms=PREVIOUS_MS["flash_attention"],
        bitwise_repeat=bitwise_repeat("flash_attention", kernel_prefill) and q_repeat,
        design="one warpgroup per 64 (position, head) rows; TMA K/V tiles of 64 keys in a 2-stage mbarrier "
               "ring, 128-byte swizzle; S by wgmma m64n64k16 from shared memory; online softmax in "
               "registers; O += P V by wgmma m64n256k16 with P as hi + lo bf16 register operands",
        ptxas=ptxas("flash_attention", "flash_attention_tc_kernel"),
        # the launch's request, computed here from Layout<HD>::BYTES (Q, two K/V
        # stages, three mbarriers, 1 KB of swizzle alignment), not read from the build
        dynamic_smem_bytes_computed=5 * (hd // 64) * 64 * 128 + 3 * 8 + 1024,
        sass=sass_census("flash_attention", "flash_attention_tc_kernel"),
        shapes=f"q {tuple(q.shape)}, kv {tuple(k.shape)}, causal, window {W} ({pairs} visible pairs a head); "
               f"qwen3-moe: q (1, 128, 64, 128), kv (1, 128, 4, 128), causal",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    del q, k, v, kt, vt, qt, band
    torch.cuda.empty_cache()

    rows["rglru_scan"] = rglru_kernel_row(dev, gen, tol, hcfg.lru_width)
    return rows


def rglru_kernel_row(dev, gen, tol, Wl):
    """Kernel 12 at the hybrid cell's admission shapes (RecurrentGemma-2B's
    2,560 channels, one prompt of 2,048, 3,072 or 4,096 tokens), f32 gates
    (the model's) and bf16 ones, each against its plain version at the f32
    bound, with a random h0.  The headline is the 4,096-token f32 call: its
    time beside the replaced design's (``previous_ms``), its device time
    (the kernel and the flags' memset) at each prompt length for both input
    types, the bf16 build's own bound, registers, spills, SASS census, the
    build taken and a bitwise repeat of each."""
    import torch

    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref

    bf16 = torch.bfloat16
    a32 = torch.rand((1, H_PROMPT, Wl), generator=gen, device=dev) * 0.499 + 0.5
    b32 = torch.randn((1, H_PROMPT, Wl), generator=gen, device=dev) * 0.1
    h0 = torch.randn((1, Wl), generator=gen, device=dev)
    a16, b16 = a32.to(bf16), b32.to(bf16)

    def work(T, in_bytes):
        nbytes = T * Wl * (2 * in_bytes + 4) + Wl * 4
        return nbytes, 2.0 * T * Wl

    errs, by_prompt = {}, {}
    for T in (2048, 3072, H_PROMPT):  # the hybrid cell's prompt buckets; a prefix of one batch row is contiguous
        entry = {}
        for tag, (a, b) in (("f32", (a32, b32)), ("bf16", (a16, b16))):
            a, b = a[:, :T], b[:, :T]
            errs[f"T={T} {tag}"] = check_close(f"rglru_scan T={T} {tag}", rg_ops.rglru_scan(a, b, h0),
                                               rg_ref.linear_scan(a, b, h0), tol["f32" if tag == "f32" else "f32_out"])

            def kernel(a=a, b=b):
                return rg_ops.rglru_scan(a, b, h0)

            nbytes, flops = work(T, a.element_size())
            entry[tag] = dict(device_ms=device_ms(kernel, "", n=20),
                              kernel_device_ms=device_ms(kernel, "rglru_chunk_kernel", n=20),
                              **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops, F32_FLOPS))))
        by_prompt[f"T={T}"] = entry

    def kernel32():
        return rg_ops.rglru_scan(a32, b32, h0)

    def kernel16():
        return rg_ops.rglru_scan(a16, b16, h0)

    nbytes, flops = work(H_PROMPT, 4)
    nbytes16, flops16 = work(H_PROMPT, 2)
    paths = {tag: rg_ops.rglru_scan_path(Wl, all(t.data_ptr() % (rg_ops.LANE_CHANNELS * t.element_size()) == 0
                                                 for t in (a, b)))
             for tag, (a, b) in (("f32", (a32, b32)), ("bf16", (a16, b16)))}
    if set(paths.values()) != {"vector"}:
        raise AssertionError(f"rglru_scan: builds taken {paths}")
    row = dict(
        max_abs_err=errs[f"T={H_PROMPT} f32"], max_abs_err_bf16_inputs=errs[f"T={H_PROMPT} bf16"],
        max_abs_err_by_prompt=errs,
        ms=time_ms(kernel32, iters=20), ms_bf16_inputs=time_ms(kernel16, iters=20),
        previous_ms=PREVIOUS_MS["rglru_scan"], previous_ms_bf16_inputs=PREVIOUS_MS["rglru_scan_bf16"],
        device_ms=by_prompt[f"T={H_PROMPT}"]["f32"]["device_ms"],
        device_ms_bf16_inputs=by_prompt[f"T={H_PROMPT}"]["bf16"]["device_ms"],
        by_prompt=by_prompt,
        plain_ms=time_ms(lambda: rg_ref.linear_scan(a32, b32, h0), iters=1, reps=3),
        library_ms=None,
        library_call="none: no PyTorch call computes a linear recurrence (torch has no associative scan; "
                     "cumprod/cumsum forms overflow or lose precision over 4,096 steps)",
        bitwise_repeat=bitwise_repeat("rglru_scan f32", kernel32) and bitwise_repeat("rglru_scan bf16", kernel16),
        paths=paths, chunk=rg_ops.CHUNK, segment=rg_ops.SEGMENT,
        design=f"chunks of {rg_ops.CHUNK} steps x tiles of 32 lanes ({rg_ops.LANE_CHANNELS} channels of a and b a "
               f"lane a step), "
               f"{rg_ops.CHUNK // rg_ops.SEGMENT} segments of {rg_ops.SEGMENT} steps a chunk in registers; "
               f"aggregates published under flags, the carry folded from h0 over every earlier chunk in "
               f"ascending order; one launch after a memset of the flags",
        ptxas=ptxas("rglru_scan", "rglru_chunk_kernel"),
        sass=sass_census("rglru_scan", "rglru_chunk_kernel"),
        shapes=f"a, b {tuple(a32.shape)} f32 (the model's gates) and bf16, h0 {tuple(h0.shape)}; also the "
               f"first 2,048 and 3,072 steps",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops, F32_FLOPS))),
        bytes_bf16_inputs=nbytes16,
        **dict(zip(("bound_ms_bf16_inputs", "bound_by_bf16_inputs"), bound(nbytes16, flops16, F32_FLOPS))),
    )
    del a32, b32, a16, b16
    torch.cuda.empty_cache()
    return row


def int8_kernel_rows(cfg, dev, gen, tol):
    """The int8 branches 1q, 2q, 5q and 6q at the shapes of rows 1, 2, 5
    and 6: int8 K/V with per-row f32 scales, or int8 expert stacks with
    (3, E) f32 scales, quantized from random f32 data.  Each launch is held
    BITWISE against the same kernel on the dequantized f32 buffer (f32 q or
    x; with a bf16 q, that launch's output rounded once to bf16), and
    against its plain version at its row's tolerance.  Bounds count the
    int8 payload at 1 byte and each scale at 4.  No one PyTorch call reads
    int8 K/V or int8 experts, so ``library_ms`` is null; the composite
    "dequantize + SDPA" (or "dequantize + gather + bmm x3") is timed
    beside it."""
    import torch

    from repro_torch.core.control_plane import route_topk_decode
    from repro_torch.core.quant import quantize_int8
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.moe_decode import ops as md_ops
    from repro_torch.kernels.moe_decode import ref as md_ref

    bf16 = torch.bfloat16
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    E, k, d, f = cfg.num_experts, cfg.top_k, cfg.d_model, cfg.d_ff_expert
    no_library = "none: no PyTorch call reads int8 K/V or int8 expert stacks with per-row or per-expert scales"
    rows = {}

    def int8_rows(shape):
        c, s = quantize_int8(torch.randn(shape, generator=gen, device=dev), axis=(-2, -1))
        return c, s[..., 0, 0].contiguous()

    def deq(c, s):
        return c.float() * s[..., None, None]

    def exact(name, run, q32, q16, c8, scales, cd):
        """The int8 launch (f32 and bf16 q) against the f32 launch on the
        dequantized buffers ``cd``; returns the bf16-q int8 output."""
        if not torch.equal(run(q32, *c8, scales), run(q32, *cd, None)):
            raise AssertionError(f"{name}: the int8 launch (f32 q) is not bitwise the dequantized launch")
        got = run(q16, *c8, scales)
        if not torch.equal(got, run(q16.float(), *cd, None).to(bf16)):
            raise AssertionError(f"{name}: the int8 launch (bf16 q) is not bitwise the dequantized launch")
        return got

    # ---- 1q: row 1's chain, 4 slots x spec 4 over a 164-row int8 cache
    B, T = SLOTS, SPEC
    max_len = PROMPT + GEN + SPEC
    base = torch.tensor([70, 100, 130, max_len - SPEC], dtype=torch.int32, device=dev)
    lengths = (base[:, None] + torch.arange(1, T + 1, dtype=torch.int32, device=dev)).reshape(-1).contiguous()
    chain = torch.full((T,), -1, dtype=torch.int32, device=dev)
    words = torch.tensor([1, 3, 5, 11], dtype=torch.int32, device=dev)
    q32 = torch.randn((B, T, nq, hd), generator=gen, device=dev)
    q = q32.to(bf16)
    (k8, ks), (v8, vs) = int8_rows((B, max_len, nkv, hd)), int8_rows((B, max_len, nkv, hd))
    scales = torch.stack([ks, vs]).reshape(2, -1).contiguous()
    kd, vd = deq(k8, ks), deq(v8, vs)
    for w in (chain, words):
        got = exact("flash_decode int8", lambda qq, kk, vv, sc: fa_ops.flash_decode_kernel(
            qq, kk, vv, lengths, w, base, sc), q32, q, (k8, v8), scales, (kd, vd))
    err32 = check_close("flash_decode int8 f32 q vs plain", fa_ops.flash_decode_kernel(
        q32, k8, v8, lengths, chain, base, scales), fa_ref.flash_decode(q32, k8, v8, lengths, chain, base, scales),
        tol["f32"])
    got = fa_ops.flash_decode_kernel(q, k8, v8, lengths, chain, base, scales)
    err = check_bf16("flash_decode int8 vs plain", got, fa_ref.flash_decode(q, k8, v8, lengths, chain, base, scales))
    mask = (torch.arange(max_len, device=dev)[None, None, :] < lengths.reshape(B, T)[:, :, None])[:, None]
    qt = q.transpose(1, 2)

    def composite_decode():
        kt, vt = (deq(c, s).to(bf16).transpose(1, 2).repeat_interleave(nq // nkv, 1) for c, s in ((k8, ks), (v8, vs)))
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    L = lengths.reshape(B, T).long()
    kv_rows = int(L.max(dim=1).values.sum())
    nbytes = 2 * q.numel() * 2 + kv_rows * (nkv * hd + 4) * 2 + (B * T + T + B) * 4
    flops = float(L.sum()) * nq * hd * 4 + kv_rows * nkv * hd * 2.0
    rows["flash_decode_int8"] = dict(
        max_abs_err=err, max_abs_err_f32=err32, bitwise_vs_dequantized_launch=True,
        ms=time_ms(lambda: fa_ops.flash_decode_kernel(q, k8, v8, lengths, chain, base, scales), iters=50),
        device_ms=device_ms(lambda: fa_ops.flash_decode_kernel(q, k8, v8, lengths, chain, base, scales), ""),
        previous_ms=PREVIOUS_MS["flash_decode_int8"], previous_device_ms=PREVIOUS_DEVICE_MS["flash_decode_int8"],
        plain_ms=time_ms(lambda: fa_ref.flash_decode(q, k8, v8, lengths, chain, base, scales)),
        library_ms=None, library_call=no_library,
        composite_ms=time_ms(composite_decode, iters=50),
        composite_call="dequantize K/V to bf16 + scaled_dot_product_attention (boolean mask, kv heads expanded)",
        shapes=f"q {tuple(q.shape)} bf16 (and f32), int8 kv {tuple(k8.shape)} + scales {tuple(scales.shape)}, "
               f"lengths {lengths.tolist()}; chain and tree words",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    del k8, v8, kd, vd, q, q32, qt

    # ---- 2q: row 2's 16 decode tokens, top-8 of 128 int8 experts
    Tt = B * T
    x32 = torch.randn((Tt, d), generator=gen, device=dev)
    router = torch.randn((d, E), generator=gen, device=dev) * 0.02
    plan = route_topk_decode(x32, router, k)
    ids, w = plan.expert_ids.contiguous(), plan.weights.contiguous()
    x = x32.to(bf16)
    stacks, scl = [], []
    for shape, a in (((E, d, f), d ** -0.5), ((E, d, f), d ** -0.5), ((E, f, d), f ** -0.5)):
        w8, s = quantize_int8(torch.randn(shape, generator=gen, device=dev) * a, axis=(1, 2))
        stacks.append(w8)
        scl.append(s[:, 0, 0])
        torch.cuda.empty_cache()
    mscales = torch.stack(scl).contiguous()
    got = md_ops.decode_moe_kernel(x, ids, w, *stacks, mscales)
    got32 = md_ops.decode_moe_kernel(x32, ids, w, *stacks, mscales)
    deq_stacks = [c.float() * s[:, None, None] for c, s in zip(stacks, mscales)]
    for name, g, xx in (("bf16 x", got, x.float()), ("f32 x", got32, x32)):
        if not torch.equal(g, md_ops.decode_moe_kernel(xx, ids, w, *deq_stacks)):
            raise AssertionError(f"decode_moe int8 ({name}): not bitwise the dequantized launch")
    del deq_stacks
    torch.cuda.empty_cache()
    err = check_close("decode_moe int8 vs plain", got, md_ref.decode_moe(x, ids, w, *stacks, mscales), tol["f32_out"])
    err32 = check_close("decode_moe int8 f32 x vs plain", got32, md_ref.decode_moe(x32, ids, w, *stacks, mscales),
                        tol["f32"])
    distinct = int(torch.unique(ids).numel())
    e_flat = ids.reshape(-1).long()

    def composite_moe():
        xs = x.repeat_interleave(k, 0)[:, None]
        wg, wu, wd = ((c[e_flat].float() * s[e_flat][:, None, None]).to(bf16) for c, s in zip(stacks, mscales))
        h = torch.nn.functional.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wu)
        return (torch.bmm(h, wd)[:, 0].float() * w.reshape(-1, 1)).reshape(Tt, k, d).sum(1)

    nbytes = distinct * (3 * d * f + 3 * 4) + Tt * d * 2 + Tt * k * 8 + Tt * d * 4
    flops = Tt * k * 6.0 * d * f
    def kernel_moe():
        return md_ops.decode_moe_kernel(x, ids, w, *stacks, mscales)

    ms, comp_ms, turns = in_turns(kernel_moe, composite_moe, iters=10)
    rows["decode_moe_int8"] = dict(
        max_abs_err=err, max_abs_err_f32=err32, bitwise_vs_dequantized_launch=True,
        ms=ms, composite_ms=comp_ms, ms_in_turns=turns,
        composite_call="gather of the named experts' int8 stacks + dequantize to bf16 + torch.bmm x3 (in turns)",
        device_ms=device_ms(kernel_moe, "", n=10), device_ms_by_launch=moe_decode_launches(kernel_moe),
        plain_ms=time_ms(lambda: md_ref.decode_moe(x, ids, w, *stacks, mscales), iters=3, reps=3),
        library_ms=None, library_call=no_library,
        bitwise_repeat=bitwise_repeat("decode_moe int8", kernel_moe), previous_ms=PREVIOUS_MS["decode_moe_int8"],
        ptxas=ptxas("moe_decode", *MOE_DECODE_INT8), sass=sass_census("moe_decode", *MOE_DECODE_INT8),
        shapes=f"x {tuple(x.shape)} bf16 (and f32), top-{k} of {E} int8 experts ({distinct} distinct), d {d}, f {f}",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    del stacks, x, x32
    torch.cuda.empty_cache()

    # ---- 5q: row 5's paged tree 2,1 over 60 int8 pages x 16 rows
    B, T, ps, mp, n_pages, base_l, base, lengths, words, table_np, table = _paged_case(dev)
    q32 = torch.randn((B, T, nq, hd), generator=gen, device=dev)
    q = q32.to(bf16)
    (pk8, pks), (pv8, pvs) = int8_rows((n_pages * ps, nkv, hd)), int8_rows((n_pages * ps, nkv, hd))
    pscales = torch.stack([pks, pvs]).contiguous()
    pkd, pvd = deq(pk8, pks), deq(pv8, pvs)

    def run_paged(qq, kk, vv, sc):
        return fa_ops.flash_decode_paged_kernel(qq, kk, vv, lengths, table, words, base, sc, page_size=ps)

    got = exact("flash_decode_paged int8", run_paged, q32, q, (pk8, pv8), pscales, (pkd, pvd))
    err = check_bf16("flash_decode_paged int8 vs plain", got, fa_ref.flash_decode_paged(
        q, pk8, pv8, lengths, table, words, base, ps, pscales))
    err32 = check_close("flash_decode_paged int8 f32 q vs plain", run_paged(q32, pk8, pv8, pscales),
                        fa_ref.flash_decode_paged(q32, pk8, pv8, lengths, table, words, base, ps, pscales), tol["f32"])
    S = mp * ps
    vis = fa_ref.visible_rows(lengths, words, base, B, T, S)[:, None]
    qt = q.transpose(1, 2)
    gather_rows = ((table.reshape(B, mp).long().clamp(min=0) * ps)[:, :, None]
                   + torch.arange(ps, device=dev)).reshape(B, S)

    def composite_paged():
        kt, vt = (deq(c[gather_rows], s[gather_rows]).to(bf16).transpose(1, 2).repeat_interleave(nq // nkv, 1)
                  for c, s in ((pk8, pks), (pv8, pvs)))
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis)

    Lmax = lengths.reshape(B, T).max(dim=1).values.tolist()
    rows_touched = {(int(table_np[b, p // ps]), p % ps) for b in range(B) for p in range(Lmax[b])}
    nbytes = 2 * q.numel() * 2 + len(rows_touched) * (nkv * hd + 4) * 2 + (B * T + B * mp + T + B) * 4
    flops = float(vis.sum()) * nq * hd * 4 + len(rows_touched) * nkv * hd * 2.0
    rows["flash_decode_paged_int8"] = dict(
        max_abs_err=err, max_abs_err_f32=err32, bitwise_vs_dequantized_launch=True,
        ms=time_ms(lambda: run_paged(q, pk8, pv8, pscales), iters=50),
        device_ms=device_ms(lambda: run_paged(q, pk8, pv8, pscales), ""),
        previous_ms=PREVIOUS_MS["flash_decode_paged_int8"],
        previous_device_ms=PREVIOUS_DEVICE_MS["flash_decode_paged_int8"],
        plain_ms=time_ms(lambda: fa_ref.flash_decode_paged(q, pk8, pv8, lengths, table, words, base, ps, pscales)),
        library_ms=None, library_call=no_library,
        composite_ms=time_ms(composite_paged, iters=50),
        composite_call="gather through the block table + dequantize to bf16 + scaled_dot_product_attention",
        shapes=f"q {tuple(q.shape)}, int8 pool {tuple(pk8.shape)} + scales {tuple(pscales.shape)}, base {base_l}, "
               f"tree {TREE}, {len(rows_touched)} distinct rows read",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    del pk8, pv8, pkd, pvd, q, q32, qt

    # ---- 6q: row 6's window decode, RecurrentGemma-2B heads over int8 rolling buffers
    from repro_torch.configs import get_config

    hcfg = get_config(HYBRID)
    hq, hkv, hhd, W = hcfg.num_heads, hcfg.num_kv_heads, hcfg.resolved_head_dim, hcfg.local_window
    B = H_SLOTS
    idx = [2100, 2900, 3600, 4160]
    pos = torch.tensor(idx, dtype=torch.int32, device=dev)
    q32 = torch.randn((B, 1, hq, hhd), generator=gen, device=dev)
    q = q32.to(bf16)
    (wk8, wks), (wv8, wvs) = int8_rows((B, W, hkv, hhd)), int8_rows((B, W, hkv, hhd))
    wscales = torch.stack([wks, wvs]).reshape(2, -1).contiguous()
    wkd, wvd = deq(wk8, wks), deq(wv8, wvs)

    def run_window(qq, kk, vv, sc):
        return fa_ops.flash_decode_window_kernel(qq, kk, vv, pos, sc, window=W)

    got = exact("flash_decode_window int8", run_window, q32, q, (wk8, wv8), wscales, (wkd, wvd))
    err = check_bf16("flash_decode_window int8 vs plain", got,
                     fa_ref.flash_decode_window(q, wk8, wv8, pos, W, wscales))
    err32 = check_close("flash_decode_window int8 f32 q vs plain", run_window(q32, wk8, wv8, wscales),
                        fa_ref.flash_decode_window(q32, wk8, wv8, pos, W, wscales), tol["f32"])
    p_all = pos.long()[:, None] - W + 1 + torch.arange(W, device=dev)[None, :]
    slots = torch.remainder(p_all.clamp(min=0), W)
    bidx = torch.arange(B, device=dev)[:, None]
    vis = (p_all >= 0)[:, None, None, :]
    qt = q.transpose(1, 2)

    def composite_window():
        kt, vt = (deq(c[bidx, slots], s[bidx, slots]).to(bf16).transpose(1, 2).repeat_interleave(hq // hkv, 1)
                  for c, s in ((wk8, wks), (wv8, wvs)))
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=vis)

    n_vis = [min(W, p + 1) for p in idx]
    nbytes = 2 * q.numel() * 2 + sum(n_vis) * (hkv * hhd + 4) * 2 + B * 4
    flops = float(sum(n_vis)) * hq * hhd * 4 + sum(n_vis) * hkv * hhd * 2.0
    ms, comp_ms, turns = in_turns(lambda: run_window(q, wk8, wv8, wscales), composite_window, iters=20)
    chunk = fa_ops.WINDOW_CHUNK
    rows["flash_decode_window_int8"] = dict(
        max_abs_err=err, max_abs_err_f32=err32, bitwise_vs_dequantized_launch=True,
        ms=ms, plain_ms=time_ms(lambda: fa_ref.flash_decode_window(q, wk8, wv8, pos, W, wscales), iters=5, reps=3),
        library_ms=None, library_call=no_library,
        composite_ms=comp_ms, ms_in_turns=turns,
        device_ms=device_ms(lambda: run_window(q, wk8, wv8, wscales), "window_"),
        composite_call="gather the window into position order + dequantize to bf16 + scaled_dot_product_attention",
        previous_ms=PREVIOUS_MS["flash_decode_window_int8"],
        bitwise_repeat=bitwise_repeat("flash_decode_window int8", lambda: run_window(q, wk8, wv8, wscales)),
        design=f"kernel 6's split over chunks of {chunk} rows with int8 rows copied as stored, each element "
               f"multiplied by its row's scale (__fmul_rn) before any dot",
        ptxas=ptxas("flash_decode", "window_split_kernelI13__nv_bfloat16aLi256EE",
                    "window_merge_kernelI13__nv_bfloat16Li256E"),
        dynamic_smem_bytes_computed=2 * chunk * hhd + 4 * (chunk * 20 + 2 * chunk),  # as split_smem lays it out
        shapes=f"q {tuple(q.shape)}, int8 rolling kv {tuple(wk8.shape)} + scales {tuple(wscales.shape)}, "
               f"positions {idx}, window {W}",
        bytes=nbytes, flops=flops, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
    )
    del wk8, wv8, wkd, wvd, q, q32, qt
    torch.cuda.empty_cache()
    return rows


def ssd_work(T, H, P, N, q, in_bytes, with_h0=False, with_cum=True):
    """(bytes, flops) one scan needs at batch 1 over chunks of ``q`` steps:
    each input read once (x, B, C in ``in_bytes`` each, dt in f32, and with
    ``with_cum`` the CUDA-core wrapper's cum in f32, h0), y and the final
    state written once in f32; per chunk of n rows, C B^T over its n (n +
    1) / 2 causal pairs ONCE (it does not depend on the head), and per head
    S @ x over the same pairs plus the two N x P products (carried-in state
    and state update)."""
    flops = 0.0
    for t0 in range(0, T, q):
        n = min(q, T - t0)
        pairs = n * (n + 1) / 2
        flops += 2 * pairs * N + H * (2 * pairs * P + 4 * n * N * P)
    nbytes = ((T * H * P + 2 * T * N) * in_bytes + (2 if with_cum else 1) * T * H * 4 + T * H * P * 4
              + H * N * P * 4 * (2 if with_h0 else 1))
    return nbytes, flops


def ssd_kernel_row(dev, gen, tol):
    """Kernel 11 at the SSM cell's admission shape (Mamba-2-2.7B: 80 heads of
    64, state 128): a 4,096-token prompt from a zero state and a ragged
    2,100-token one from a random ``h0``, with bf16 x, B and C as views of
    one projection (the bf16 model's layout; the tensor-core build, chunks
    of 256) and in f32 (the CUDA-core build, chunks of 64), each against
    its plain version at the model's chunk of 256, held at the f32 bound on
    y and on the final state.  The row's headline is the serving path's
    bf16 call: its time beside the replaced design's (``previous_ms``), its
    device time by launch, its bound at the bf16 tensor rate beside the
    chunk-state scratch, registers, spills, SASS census and a bitwise
    repeat; the f32 call keeps its CUDA-core bound."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    cfg = get_config(SSM)
    P, N, Q = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    H = cfg.ssm_expand * cfg.d_model // P
    a = -torch.linspace(1.0, 16.0, H, device=dev)  # the model's init decays, -exp(A_log)

    def inputs(T, dtype):
        """x, B and C as views of one (1, T, H P + 2 N) projection, as the
        model passes them."""
        proj = (torch.randn((1, T, H * P + 2 * N), generator=gen, device=dev) * 0.5).to(dtype)
        dt = torch.nn.functional.softplus(torch.randn((1, T, H), generator=gen, device=dev) - 1.0)
        return proj[..., :H * P].reshape(1, T, H, P), dt, a, proj[..., H * P:H * P + N], proj[..., H * P + N:]

    def check(tag, args, h0=None):
        y, h = ssd_ops.ssd_scan(*args, Q, h0=h0)
        yr, hr = ssd_ref.ssd_chunked(*args, Q, h0)
        return max(check_close(f"ssd_scan y {tag}", y, yr, tol["f32"]),
                   check_close(f"ssd_scan state {tag}", h, hr, tol["f32"]))

    def path(args):
        x, _, _, bm, cm = args
        return ssd_ops.ssd_scan_path(x.dtype, N, P, ssd_ops.tma_ready(x, bm, cm))

    errs, paths = {}, {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        ragged = inputs(2100, dtype)
        paths[f"T=2100 {tag}"] = path(ragged)
        errs[f"T=2100 from h0 {tag}"] = check(f"T=2100 from h0 {tag}", ragged,
                                              torch.randn((1, H, N, P), generator=gen, device=dev))
        del ragged
    args16 = inputs(H_PROMPT, torch.bfloat16)
    args = (args16[0].float(), args16[1], a, args16[3].float(), args16[4].float())
    paths[f"T={H_PROMPT} bf16"], paths[f"T={H_PROMPT} f32"] = path(args16), path(args)
    if paths[f"T={H_PROMPT} bf16"] != "tensor_cores" or paths[f"T={H_PROMPT} f32"] != "cuda_cores":
        raise AssertionError(f"ssd_scan: builds taken {paths}")
    err32 = check(f"T={H_PROMPT} f32", args)
    err = check(f"T={H_PROMPT} bf16 inputs", args16)

    def kernel():
        return ssd_ops.ssd_scan(*args16, Q)

    nbytes, flops = ssd_work(H_PROMPT, H, P, N, Q, 2, with_cum=False)
    q32 = min(Q, H_PROMPT, ssd_ops.QMAX)
    nbytes32, flops32 = ssd_work(H_PROMPT, H, P, N, q32, 4)
    nc = -(-H_PROMPT // ssd_ops.TC_CHUNK)
    scratch = dict(chunk_states_f32=nc * H * N * P * 4, entering_states_bf16_hi_lo=nc * H * N * P * 4,
                   cum_dt_decay_f32=nc * H * (2 * ssd_ops.TC_CHUNK + 1) * 4)
    row = dict(
        max_abs_err=err, max_abs_err_f32=err32, max_abs_err_ragged_h0=errs,
        ms=time_ms(kernel, iters=10), previous_ms=PREVIOUS_MS["ssd_scan"],
        device_ms=device_ms(kernel, "", n=10),
        device_ms_by_phase={ph: device_ms(kernel, ph, n=10) for ph in ("chunk_state", "state_pass", "chunk_scan")},
        ms_f32=time_ms(lambda: ssd_ops.ssd_scan(*args, Q), iters=10),
        plain_ms=time_ms(lambda: ssd_ref.ssd_chunked(*args16, Q), iters=2, reps=3),
        library_ms=None,
        library_call="none: no PyTorch call computes a selective (input-dependent decay) state-space scan",
        bitwise_repeat=bitwise_repeat("ssd_scan", lambda: torch.cat([t.reshape(-1) for t in kernel()])),
        paths=paths, kernel_chunk=ssd_ops.TC_CHUNK, kernel_chunk_f32=q32, model_chunk=Q,
        ptxas=ptxas("ssd_scan", "chunk_state", "state_pass", "chunk_scan"),
        sass=sass_census("ssd_scan", "chunk_state", "state_pass", "chunk_scan"),
        scratch_bytes=scratch,
        scratch_traffic_bytes=4 * nc * H * N * P * 4,
        scratch_traffic="chunk states written by (i) and read by (ii), entering states written by (ii) and read "
                        "by (iii), each once (the reads of (iii)'s four row tiles beyond the first counted as L2 hits)",
        shapes=f"x {tuple(args16[0].shape)} bf16 (a view of the (1, {H_PROMPT}, {H * P + 2 * N}) projection), dt "
               f"(1, {H_PROMPT}, {H}) f32, B and C (1, {H_PROMPT}, {N}) views, zero state; also T = 2100 from a "
               f"random h0, and f32 x, B, C (ms_f32)",
        bytes=nbytes, flops=flops, flops_count="C B^T once per chunk, causal pairs only, chunk 256",
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
        bytes_f32=nbytes32, flops_f32=flops32, flops_f32_count="the CUDA-core build's chunk of 64, f32 CUDA cores",
        **dict(zip(("bound_ms_f32", "bound_by_f32"), bound(nbytes32, flops32, F32_FLOPS))),
    )
    del args, args16
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phases 4-5: serving
# ---------------------------------------------------------------------------


CONTIGUOUS_KERNELS = ("flash_decode", "decode_moe", "gather_swiglu", "down_combine", "flash_attention")
PAGED_KERNELS = ("flash_decode_paged", "decode_moe", "gather_swiglu", "down_combine", "flash_attention")
HYBRID_KERNELS = ("flash_decode_window", "flash_attention", "rglru_scan")
SSM_KERNELS = ("ssd_scan",)
# the expert-parallel plane: the a2a body at admission, kernel 2 on the shard
EP_KERNELS = ("flash_decode", "decode_moe", "gather_swiglu", "grouped_gemm", "moe_dispatch", "moe_combine",
              "flash_attention")


def smoke_twin(dev, names=None, meshes=(None, None)):
    """The f32 smoke configs served on the card (kernels) and on the CPU
    (plain versions) from the same weights: greedy streams identical.  At
    spec 4 some drafts must be accepted, so the plan-row selection by
    ``prev_accept > 0`` runs on the card; the same holds for the trees
    (plan rows selected by parent, the contiguous commit, and on the paged
    plane the commit maps fused into the next launch).  The hybrid run
    serves RecurrentGemma's smoke stack (rec, rec, attn) with prompts of
    24/36/48 tokens past its window of 16, so every rolling buffer wraps;
    the SSM run serves Mamba-2's smoke stack with prompts of 260/390/520
    tokens, past the full model's chunk of 256 and each with a ragged tail
    (the smoke chunk is 16).  ``ep_spec4`` serves the spec-4 chain through
    the expert-parallel plane: ``meshes`` are a one-rank (1, 1) mesh on the
    card and one on the CPU over the same process group; it runs only when
    ``names`` asks for it.  The ``int8_*`` runs (phase ``smoke_twin_int8``,
    also only when asked for) serve int8 KV rows and int8 expert twins: the
    spec-4 chain, the paged plane with tree 2,1, the model drafter and a
    16-token shared prefix (kernel 5's int8 branch, trie adoption of int8
    pages with their scales, then a CoW page copy on the card), and the
    hybrid over rolling windows.  On a stream mismatch an int8 run names
    the first differing request and the first cache row whose int8 codes
    differ between card and CPU, with both sides' codes and scales."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.plans import TreePlan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    runs = {
        "spec1_ngram": dict(),
        "spec4_repeat": dict(spec=4, drafter="repeat"),
        "spec4_ngram": dict(spec=4),
        "tree2x2_model": dict(spec=5, drafter="model", tree=(2, 2)),
        "paged_tree2x1_ps8": dict(spec=4, tree=(2, 1), ps=8),
        "paged_spec3_shared16": dict(spec=3, ps=16, shared=16),
        "hybrid_spec1": dict(arch=HYBRID, slots=2, prompt=48, requests=4),
        "ssm_spec1": dict(arch=SSM, slots=2, prompt=520, requests=4),
        "ep_spec4": dict(spec=4, mesh=True),
        "int8_spec4_ngram": dict(spec=4, int8=True),
        "int8_paged_tree2x1_model_shared16": dict(spec=4, tree=(2, 1), drafter="model", ps=8, shared=16, int8=True),
        "int8_hybrid_spec1": dict(arch=HYBRID, slots=2, prompt=48, requests=4, int8=True),
    }
    names = names or [n for n, r in runs.items() if not (r.get("mesh") or r.get("int8"))]
    out = {}
    for name in names:
        run = runs[name]
        r = dict(arch=ARCH, spec=1, drafter="ngram", tree=None, ps=0, shared=0, slots=3, prompt=16, gen=8,
                 requests=6, mesh=False, int8=False)
        r.update(run)
        spec, drafter, ps, shared = r["spec"], r["drafter"], r["ps"], r["shared"]
        tree = TreePlan.from_branching(r["tree"]) if r["tree"] else None
        quant = dict(kv_dtype="int8", expert_dtype="int8" if r["arch"] == ARCH else "") if r["int8"] else {}
        cfg = dataclasses.replace(get_smoke_config(r["arch"]), decode_plane=True, spec_tokens=spec,
                                  paged=ps > 0, page_size=ps or 16, **quant)
        params_cpu = Model(cfg, device="cpu").init(0)
        # the draft model is the target cut to its first layer (self-drafting):
        # a drafter with weights of its own never hits on random weights
        draft_cpu = dict(params_cpu, layers=params_cpu["layers"][:1]) if drafter == "model" else None
        reqs = serve.synthetic_requests(cfg.vocab_size, r["prompt"], r["gen"], r["requests"], shared)
        max_len = r["prompt"] + shared + r["gen"] + spec
        kw = dict(tree=tree, drafter=drafter)
        card_mesh, cpu_mesh = meshes if r["mesh"] else (None, None)
        reset_launch_counts()
        rep = serve.ServeReplica(cfg, r["slots"], max_len, _to(params_cpu, dev), device=dev,
                                 drafter_params=_to(draft_cpu, dev), mesh=card_mesh, **kw)
        gpu = serve.serve_queue(rep, reqs)
        torch.cuda.synchronize()
        counts = launch_counts()
        cpu_rep = serve.ServeReplica(cfg, r["slots"], max_len, params_cpu, device="cpu", drafter_params=draft_cpu,
                                     mesh=cpu_mesh, **kw)
        cpu = serve.serve_queue(cpu_rep, reqs)
        g = {rid: res.tokens for rid, res in gpu.items()}
        c = {rid: res.tokens for rid, res in cpu.items()}
        tag = f"smoke twin {name}"
        if g != c:
            rid = min(i for i in g if g[i] != c.get(i))
            flip = first_code_flip(rep.cache, cpu_rep.cache) if r["int8"] else None
            raise AssertionError(f"{tag}: request {rid}: card stream {g[rid]} != CPU stream {c.get(rid)}; "
                                 f"first int8 row differing between card and CPU caches: {flip}")
        if len(g) != r["requests"] or any(len(t) != r["gen"] + 1 for t in g.values()):
            raise AssertionError(f"{tag}: unanswered or short streams: {g}")
        expect = {HYBRID: HYBRID_KERNELS, SSM: SSM_KERNELS}.get(
            r["arch"], EP_KERNELS if r["mesh"] else PAGED_KERNELS if ps else CONTIGUOUS_KERNELS)
        if r["int8"]:
            expect = int8_path(expect)
            if any(counts[n[:-len("_int8")]] for n in expect if n.endswith("_int8")):
                raise AssertionError(f"{tag}: a full-precision branch ran on the int8 plane: {counts}")
        if min(counts[n] for n in expect) <= 0:
            raise AssertionError(f"{tag}: a kernel of its path never launched: {counts}")
        if r["mesh"] and counts["down_combine"]:
            raise AssertionError(f"{tag}: the single-host fused pair ran on the a2a path: {counts}")
        if ps and drafter != "model" and counts["flash_decode"]:
            raise AssertionError(f"{tag}: the contiguous flash_decode ran on the paged plane: {counts}")
        # every active slot keeps its first token each launch; the rest of
        # what it keeps are accepted drafts
        draft_accepts = rep.accepted_total - rep.drafted_total // spec
        if spec > 1 and draft_accepts <= 0:
            raise AssertionError(f"{tag}: no draft token was ever accepted on the card")
        row = dict(
            streams_identical=True, requests=len(g), launches=counts, decode_launches=rep.launches,
            accepted_total=rep.accepted_total, drafted_total=rep.drafted_total, draft_accepts=draft_accepts,
            commits=rep.commits,
        )
        if r["arch"] == HYBRID:
            W = rep.cache[2]["k"].shape[1]
            if not min(len(q.prompt) for q in reqs) > W == cfg.local_window:
                raise AssertionError(f"{tag}: prompts do not pass the {W}-slot window")
            row.update(window_slots=W, prompt_lens=sorted({len(q.prompt) for q in reqs}))
        if r["arch"] == SSM:
            lens = sorted({len(q.prompt) for q in reqs})
            if not (min(lens) > 256 and all(n % cfg.ssm_chunk for n in lens)):
                raise AssertionError(f"{tag}: prompts {lens} do not cross 256 tokens with ragged tails")
            row.update(prompt_lens=lens, ssm_chunk=cfg.ssm_chunk)
        if ps:
            st = rep.paged_stats()
            if shared and st["pages_shared_total"] <= 0:
                raise AssertionError(f"{tag}: no page was shared across admissions: {st}")
            if rep.pager.snapshot() != cpu_rep.pager.snapshot():
                raise AssertionError(f"{tag}: card and CPU block tables differ")
            row.update(paged=st)
            if r["int8"]:
                row.update(cow_copies_scale_rows=cow_check(rep.cache, ps))
        out[name] = dict(row, streams=g)
    # greedy verify: the paged tree serves the same queue as the spec-4
    # chain, so its streams must be the chain's
    if "paged_tree2x1_ps8" in out:
        out["paged_tree_streams_equal_chain"] = (out["paged_tree2x1_ps8"]["streams"]
                                                 == out["spec4_ngram"]["streams"])
    for row in out.values():
        if isinstance(row, dict):
            row.pop("streams")
    return out


def int8_path(kernels):
    """A path's kernels on the int8 plane: each kernel with an int8 branch
    runs that branch."""
    return tuple(n + "_int8" if n + "_int8" in KERNELS else n for n in kernels)


def first_code_flip(card_cache, cpu_cache):
    """The first cache row whose int8 codes differ between the card's cache
    and the CPU's (layer, leaf, row index, both sides' codes where they
    differ and the row's scales), or None."""
    import torch

    for i, (a, b) in enumerate(zip(card_cache, cpu_cache)):
        for name in ("k", "v", "pk", "pv"):
            if name not in a or a[name].dtype != torch.int8:
                continue
            x, y = a[name].cpu(), b[name]
            rows = (x != y).flatten(-2).any(-1).nonzero()
            if len(rows):
                at = tuple(int(v) for v in rows[0])
                diff = (x[at] != y[at]).nonzero().tolist()
                scale = {"k": "ks", "v": "vs", "pk": "pks", "pv": "pvs"}[name]
                return dict(layer=i, leaf=name, row=at, positions=diff[:8],
                            card_codes=[int(x[at][tuple(p)]) for p in diff[:8]],
                            cpu_codes=[int(y[at][tuple(p)]) for p in diff[:8]],
                            card_scale=float(a[scale].cpu()[at]), cpu_scale=float(b[scale][at]))
    return None


def cow_check(cache, ps):
    """A copy-on-write page copy on the card, page 0 into the pool's last
    page: the int8 payload and the scale rows arrive bitwise, in every
    layer's pool."""
    import torch

    from repro_torch.models.transformer import cow_copy_page

    R = cache[0]["pk"].shape[0] - 1
    new = R // ps - 1
    cow_copy_page(cache, 0, new, ps)
    for c in cache:
        for name in ("pk", "pv", "pks", "pvs"):
            if not torch.equal(c[name][new * ps:(new + 1) * ps], c[name][:ps]):
                raise AssertionError(f"CoW on the card: {name} rows of the copied page differ")
    return True


def _to(tree, dev):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def full_width(dev):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
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
    rep.reset()
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    results = serve.serve_queue(rep, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    streams = {rid: r.tokens for rid, r in results.items()}
    if sorted(streams) != list(range(REQUESTS)) or any(r.error for r in results.values()):
        raise AssertionError(f"full width: unanswered or failed requests: {results}")
    for rid, toks in streams.items():
        if len(toks) != GEN + 1 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"full width: request {rid} stream malformed: {toks}")
    if min(counts[n] for n in CONTIGUOUS_KERNELS) <= 0:
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
    served["launches_per_step"] = launches_per_step(rep, reqs[0])
    while rep.has_work():
        rep.step()
    return served, rep


def paged_tree(dev, params, int8=False):
    """The paged cell: full_width's weights served on the paged KV plane
    (pages of 16 rows, draft tree 2,1: 4 nodes, the spec-4 chain's launch
    width) behind a 64-token shared system prompt.  Every admission after
    the first binds the system prompt's 4 pages from the prefix trie; tree
    commits ride the next launch (no commit of their own).

    The drafter is the target cut to its first layer (self-drafting): the
    ngram drafter never hits on random weights, and without accepted drafts
    the commit maps would move no row and the plan rows past 0 would never
    be read.  The drafter's own width-1 launches run the contiguous
    flash_decode and decode_moe on its 1-layer cache.

    With ``int8`` the cell runs on the quantized plane: ``params`` carry the
    int8 expert twins (:func:`with_int8_twins`), the pool holds int8 rows
    with a scale per row, so trie adoption and the commit maps move int8
    rows with their scales, and every launch, the drafter's too, runs int8
    branches only; a CoW page copy on the card ends the run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.plans import TreePlan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    tree = TreePlan.from_branching(TREE)
    quant = dict(kv_dtype="int8", expert_dtype="int8") if int8 else {}
    cfg = dataclasses.replace(get_config(ARCH), num_layers=LAYERS, decode_plane=True, spec_tokens=tree.num_nodes,
                              paged=True, page_size=PAGE, **quant)
    tag = "int8 paged tree" if int8 else "paged tree"
    reqs = serve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, REQUESTS, SHARED)

    draft_params = dict(params, layers=params["layers"][:1])

    def replica():
        return serve.ServeReplica(cfg, SLOTS, PAGED_MAX_LEN, params, tree=tree, drafter="model",
                                  drafter_params=draft_params, device=dev)

    # warm-up: one request through admission and decode (building the
    # kernels and capturing the replica's graphs), then the pool and trie
    # emptied again
    rep = replica()
    serve.serve_queue(rep, serve.synthetic_requests(cfg.vocab_size, PROMPT, 4, 1, SHARED))
    rep.reset()
    torch.cuda.synchronize()

    reset_launch_counts()
    queue, results, occupancy = list(reqs), {}, []
    t0 = time.perf_counter()
    while queue or rep.has_work():
        while queue and rep.free_slots():
            rep.admit(queue.pop(0))
        occupancy.append(rep.pager.occupancy())
        for res in rep.step():
            results[res.rid] = res
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    streams = {rid: r.tokens for rid, r in results.items()}
    if sorted(streams) != list(range(REQUESTS)) or any(r.error for r in results.values()):
        raise AssertionError(f"{tag}: unanswered or failed requests: {results}")
    for rid, toks in streams.items():
        if len(toks) != GEN + 1 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{tag}: request {rid} stream malformed: {toks}")
    # the target's launches go through the paged kernel, one per layer; the
    # contiguous flash_decode runs only in the drafter's 1-layer launches
    drafts = rep.model_drafter.launches
    path = int8_path(PAGED_KERNELS) if int8 else PAGED_KERNELS
    fd, fdp, dm = int8_path(("flash_decode", "flash_decode_paged", "decode_moe")) if int8 else (
        "flash_decode", "flash_decode_paged", "decode_moe")
    if (min(counts[n] for n in path) <= 0 or counts[fdp] != LAYERS * rep.launches
            or counts[fd] != drafts or counts[dm] != LAYERS * rep.launches + drafts):
        raise AssertionError(f"{tag}: kernel launches {counts} do not match {rep.launches} target "
                             f"launches of {LAYERS} layers and {drafts} drafter launches of 1 layer")
    if int8 and (counts["flash_decode_paged"] or counts["flash_decode"] or counts["decode_moe"]):
        raise AssertionError(f"{tag}: a full-precision branch ran on the int8 plane: {counts}")
    draft_accepts = rep.accepted_total - rep.drafted_total // tree.num_nodes
    if draft_accepts <= 0:
        raise AssertionError(f"{tag}: no draft token was ever accepted")
    st = rep.paged_stats()
    if st["pages_shared_total"] <= 0:
        raise AssertionError(f"{tag}: no page was shared across admissions: {st}")
    if rep.commits:
        raise AssertionError(f"{tag}: {rep.commits} commit passes ran outside the decode launches")
    served = dict(
        layers=LAYERS, dtype=cfg.dtype, kv_dtype=cfg.kv_dtype or cfg.dtype,
        expert_dtype=cfg.expert_dtype or cfg.dtype, page_size=PAGE, tree=list(TREE), tree_nodes=tree.num_nodes,
        slots=SLOTS, shared_prefix=SHARED, prompt_len=PROMPT, gen=GEN, requests=REQUESTS,
        drafter="model (the target's first layer)", drafter_launches=drafts,
        max_len=PAGED_MAX_LEN, pool_pages=rep.pager.num_pages,
        wall_s=wall, generated_tokens=rep.accepted_total, tok_per_s=rep.accepted_total / wall,
        decode_launches=rep.launches, ms_per_decode_launch=rep.decode_ms / max(rep.launches, 1),
        prefills=rep.prefills, prefill_ms_mean=rep.prefill_ms / max(rep.prefills, 1),
        accepts_per_launch=rep.accepted_total / max(rep.launches, 1),
        accept_rate=rep.accepted_total / max(rep.drafted_total, 1),
        draft_accepts=draft_accepts, commit_moves=rep.commit_moves,
        pages_shared_total=st["pages_shared_total"], admit_copy_rows=st["admit_copy_rows"],
        occupancy_peak=max(occupancy), occupancy_mean=sum(occupancy) / len(occupancy),
        trie_nodes=st["trie_nodes"], commit_launches=rep.commits,
        kernel_launches=counts, streams=streams,
    )
    d0 = rep.model_drafter.launches  # admission prefills the drafter but launches none of its decodes
    served["launches_per_step"] = launches_per_step(rep, reqs[0])
    served["drafter_launches_per_step"] = rep.model_drafter.launches - d0
    while rep.has_work():
        rep.step()
    if int8:
        served.update(kv_bytes=kv_bytes(rep.cache), cow_copies_scale_rows=cow_check(rep.cache, PAGE))
    return served, rep


def expert_parallel(dev, params, served):
    """The expert-parallel cell: ``full_width``'s weights and traffic served
    through the mesh-bound replica on a one-rank (data 1, model 1) mesh over
    NCCL (a process group made in-process, destroyed at the end).  Each
    admission runs the a2a body (kernels 9, 3 over the identity index, 8,
    10) once a layer and never the single-host fused pair; each decode launch
    runs kernel 2 on the shard-sliced plan and kernel 1, once a layer.  The
    first request's last-position prefill logits are held against the
    single-host model's at 2e-2 of the logit scale (bf16: the a2a path
    rounds each expert output to bf16 before the combine, the fused pair
    adds in f32 with atomics).  Then the twin ``ep_spec4`` (card vs CPU,
    the same group) and the profile of three decode launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import init_single_rank, make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import shard_params

    cfg = dataclasses.replace(get_config(ARCH), num_layers=LAYERS, decode_plane=True, spec_tokens=SPEC)
    max_len = PROMPT + GEN + SPEC
    reqs = serve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, REQUESTS)
    init_single_rank(dev)
    try:
        mesh = make_host_mesh(1, 1, dev)
        cpu_mesh = make_host_mesh(1, 1, "cpu")
        ep_params = shard_params(params, cfg, mesh)  # one rank: the same tensors
        torch.cuda.reset_peak_memory_stats()
        rep = serve.ServeReplica(cfg, SLOTS, max_len, ep_params, drafter="ngram", mesh=mesh)
        serve.serve_queue(rep, serve.synthetic_requests(cfg.vocab_size, PROMPT, 4, 1))  # warm-up
        rep.reset()
        torch.cuda.synchronize()

        reset_launch_counts()
        t0 = time.perf_counter()
        results = serve.serve_queue(rep, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = launch_counts()
        streams = {rid: r.tokens for rid, r in results.items()}
        if sorted(streams) != list(range(REQUESTS)) or any(r.error for r in results.values()):
            raise AssertionError(f"expert parallel: unanswered or failed requests: {results}")
        for rid, toks in streams.items():
            if len(toks) != GEN + 1 or not all(0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"expert parallel: request {rid} stream malformed: {toks}")
        ep = dict(
            mesh=mesh.shape, backend="cpu:gloo,cuda:nccl", layers=LAYERS, dtype=cfg.dtype, slots=SLOTS,
            prompt_len=PROMPT, gen=GEN, requests=REQUESTS, spec_tokens=SPEC, drafter="ngram",
            peak_memory_bytes=peak, wall_s=wall, generated_tokens=rep.accepted_total,
            tok_per_s=rep.accepted_total / wall, decode_launches=rep.launches,
            ms_per_decode_launch=rep.decode_ms / max(rep.launches, 1), prefills=rep.prefills,
            prefill_ms_mean=rep.prefill_ms / max(rep.prefills, 1),
            accepts_per_launch=rep.accepted_total / max(rep.launches, 1),
        )
        if counts["down_combine"] or min(counts[n] for n in EP_KERNELS) <= 0:
            raise AssertionError(f"expert parallel: kernel launches {counts}")
        step = launches_per_step(rep, reqs[0])
        want = {n: LAYERS for n in ("moe_dispatch", "gather_swiglu", "grouped_gemm", "moe_combine")}
        want["down_combine"] = 0
        got = {n: step[n]["per_admission"] for n in want}
        got_dec = {n: step[n]["per_decode_launch"] for n in ("decode_moe", "flash_decode")}
        if got != want or got_dec != {"decode_moe": LAYERS, "flash_decode": LAYERS}:
            raise AssertionError(f"expert parallel: launches per admission {got} (want {want}), per decode "
                                 f"launch {got_dec} (want {LAYERS} each)")
        while rep.has_work():
            rep.step()
        ep["decode_ms_alternating"] = alternate_decode(dev, cfg, params, rep, reqs, max_len)

        # the first request's admission logits against the single-host model's
        prompt = reqs[0].prompt[None]
        single = Model(cfg, device=dev)
        want_l = single.prefill(params, prompt, single.init_cache(1, max_len))
        got_l = rep.model.prefill(ep_params, prompt, rep.model.init_cache(1, max_len))
        scale = float(want_l.abs().max())
        err = float((got_l - want_l).abs().max())
        if not (bool(torch.isfinite(got_l).all()) and err <= 2e-2 * scale):
            raise AssertionError(f"expert parallel: admission logits differ from single-host by {err:.3e} "
                                 f"(scale {scale:.3g}, bound 2e-2 of it)")
        pairs = [(a, b) for rid, toks in streams.items() for a, b in zip(toks, served["streams"][rid])]
        ep.update(
            logits_max_abs_diff_vs_single_host=err, logits_scale=scale,
            logits_tolerance="2e-2 x max |single-host logit|",
            first_token_equal=int(got_l.argmax()) == int(want_l.argmax()),
            stream_tokens_identical_share=sum(a == b for a, b in pairs) / max(len(pairs), 1),
            kernel_launches=counts, launches_per_step=step, streams=streams,
        )
        del want_l, got_l
        twin = smoke_twin(dev, names=["ep_spec4"], meshes=(mesh, cpu_mesh))
        gate = compiled_launch(rep, cfg.vocab_size)
        prof = profile_decode(rep, cfg.vocab_size)
        del rep
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return ep, twin, prof, gate


def alternate_decode(dev, cfg, params, rep, reqs, max_len, rounds=5):
    """ms per decode launch of the single-host replica and the mesh replica
    ``rep`` on the same weights and traffic, served in turn ``rounds``
    times each, the first of each round alternating: the two phases run
    minutes apart and a launch is mostly host time, so only runs that
    interleave compare them."""
    import torch

    from repro_torch.launch import serve

    single = serve.ServeReplica(cfg, SLOTS, max_len, params, drafter="ngram", device=dev)
    serve.serve_queue(single, serve.synthetic_requests(cfg.vocab_size, PROMPT, 4, 1))  # warm-up
    out = {"single_host": [], "mesh": []}
    for i in range(rounds):
        pair = [("single_host", single), ("mesh", rep)]
        for name, r in pair if i % 2 == 0 else pair[::-1]:
            r.reset()
            serve.serve_queue(r, reqs)
            torch.cuda.synchronize()
            out[name].append(r.decode_ms / max(r.launches, 1))
    del single
    torch.cuda.empty_cache()
    return out


def serve_uncut(dev, arch, kv_dtype=""):
    """Serve ``arch`` uncut, bf16, random weights from seed 0, spec width 1
    on the contiguous decode plane: 4 slots serve 8 requests of
    2,048/3,072/4,096 prompt tokens (the CLI's buckets for ``--prompt-len
    4096``) and 64 generated tokens, after a one-request warm-up, over a KV
    cache of ``kv_dtype``.  Checks the streams and a prefill's logits;
    returns (the served record with the measured run's kernel launches, the
    replica, its requests)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(arch), decode_plane=True, spec_tokens=1, kv_dtype=kv_dtype)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    tied_bytes = params["unembed"].numel() * 4
    reqs = serve.synthetic_requests(cfg.vocab_size, H_PROMPT, H_GEN, H_REQUESTS)
    rep = serve.ServeReplica(cfg, H_SLOTS, H_MAX_LEN, params, device=dev)
    # warm-up outside the measured run: one request through admission and decode
    serve.serve_queue(rep, serve.synthetic_requests(cfg.vocab_size, H_PROMPT, 4, 1))
    rep.reset()
    torch.cuda.synchronize()
    admission_ms = []  # each admission's time, in the order the queue admits them
    admit = rep.admit

    def timed_admit(req):
        before = rep.prefill_ms
        slot = admit(req)
        admission_ms.append(rep.prefill_ms - before)
        return slot

    rep.admit = timed_admit

    reset_launch_counts()
    t0 = time.perf_counter()
    results = serve.serve_queue(rep, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del rep.admit  # the class's own admit again
    peak = torch.cuda.max_memory_allocated()  # the serving peak, before the checks below
    counts = launch_counts()
    streams = {rid: r.tokens for rid, r in results.items()}
    if sorted(streams) != list(range(H_REQUESTS)) or any(r.error for r in results.values()):
        raise AssertionError(f"{arch}: unanswered or failed requests: {results}")
    for rid, toks in streams.items():
        if len(toks) != H_GEN + 1 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{arch}: request {rid} stream malformed: {toks}")
    one = model.init_cache(1, H_MAX_LEN)
    logits = model.prefill(params, reqs[2].prompt[None], one)
    if not (logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{arch}: prefill logits not finite or of the wrong shape")
    del one, logits
    served = dict(
        arch=arch, layers=cfg.num_layers, layers_published=get_config(arch).num_layers, dtype=cfg.dtype,
        slots=H_SLOTS, prompt_len=H_PROMPT, prompt_lens=sorted({len(r.prompt) for r in reqs}), gen=H_GEN,
        requests=H_REQUESTS, spec_tokens=1, max_len=H_MAX_LEN, kv_dtype=kv_dtype or cfg.dtype,
        kv_bytes=kv_bytes(rep.cache),
        weight_bytes=weight_bytes, tied_unembed_f32_bytes=tied_bytes, init_s=init_s, peak_memory_bytes=peak,
        wall_s=wall, generated_tokens=rep.accepted_total, tok_per_s=rep.accepted_total / wall,
        decode_launches=rep.launches, ms_per_decode_launch=rep.decode_ms / max(rep.launches, 1),
        prefills=rep.prefills, prefill_ms_mean=rep.prefill_ms / max(rep.prefills, 1),
        admission_ms_each=admission_ms, prompt_len_each=[len(r.prompt) for r in reqs],
        kernel_launches=counts, distinct_tokens_per_stream=sorted(len(set(t)) for t in streams.values()),
        streams=streams,
    )
    return served, rep, reqs


def kv_bytes(cache) -> dict:
    """Bytes of the attention layers' K/V payload and of their scale rows."""
    payload = sum(c[n].numel() * c[n].element_size() for c in cache for n in ("k", "v", "pk", "pv") if n in c)
    scales = sum(c[n].numel() * c[n].element_size() for c in cache for n in ("ks", "vs", "pks", "pvs") if n in c)
    return dict(payload=payload, scales=scales)


def with_int8_twins(params):
    """``params`` with each MoE layer's int8 expert twins and scales added
    (``quantize_expert_stacks`` on the card); every other tensor shared."""
    from repro_torch.models.moe import quantize_expert_stacks

    layers = []
    for p in params["layers"]:
        if "moe" in p:
            p = dict(p, moe=dict(p["moe"], **quantize_expert_stacks(p["moe"])))
        layers.append(p)
    return dict(params, layers=layers)


def int8_full_width(dev, params, served):
    """The quantized bandwidth plane at full width: ``full_width``'s weights
    plus their int8 expert twins, an int8 KV cache, and ``full_width``'s
    traffic (4 slots, prompts of 64/96/128 tokens, 32 generated, 8 requests,
    spec 4, ngram).  Each decode launch runs the int8 branches of kernels 1
    and 2 once a layer and neither full-precision branch; admission runs the
    full-precision prefill (kernels 7, 3, 4) and writes quantized rows.
    Weight bytes split into full-precision and int8 (twins and scales)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config(ARCH), num_layers=LAYERS, decode_plane=True, spec_tokens=SPEC,
                              kv_dtype="int8", expert_dtype="int8")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params8 = with_int8_twins(params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    int8_bytes = sum(t.numel() * t.element_size() for p in params8["layers"] for n, t in p.get("moe", {}).items()
                     if n.endswith(("_q", "_s")))
    max_len = PROMPT + GEN + SPEC
    reqs = serve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, REQUESTS)
    rep = serve.ServeReplica(cfg, SLOTS, max_len, params8, drafter="ngram", device=dev)
    serve.serve_queue(rep, serve.synthetic_requests(cfg.vocab_size, PROMPT, 4, 1))  # warm-up
    rep.reset()
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    results = serve.serve_queue(rep, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    streams = {rid: r.tokens for rid, r in results.items()}
    if sorted(streams) != list(range(REQUESTS)) or any(r.error for r in results.values()):
        raise AssertionError(f"int8 full width: unanswered or failed requests: {results}")
    for rid, toks in streams.items():
        if len(toks) != GEN + 1 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"int8 full width: request {rid} stream malformed: {toks}")
    path = int8_path(CONTIGUOUS_KERNELS)
    if min(counts[n] for n in path) <= 0 or counts["flash_decode"] or counts["decode_moe"]:
        raise AssertionError(f"int8 full width: kernel launches {counts}")
    step = launches_per_step(rep, reqs[0])
    per_launch = {n: step[n]["per_decode_launch"] for n in ("flash_decode_int8", "decode_moe_int8",
                                                            "flash_decode", "decode_moe")}
    if per_launch != {"flash_decode_int8": LAYERS, "decode_moe_int8": LAYERS, "flash_decode": 0, "decode_moe": 0}:
        raise AssertionError(f"int8 full width: launches per decode launch {per_launch}")
    one = rep.model.init_cache(1, max_len)
    logits = rep.model.prefill(params8, reqs[0].prompt[None], one)
    if not (logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all())):
        raise AssertionError("int8 full width: prefill logits not finite or of the wrong shape")
    pairs = [(a, b) for rid, toks in streams.items() for a, b in zip(toks, served["streams"][rid])]
    out = dict(
        layers=LAYERS, dtype=cfg.dtype, kv_dtype="int8", expert_dtype="int8", slots=SLOTS, prompt_len=PROMPT,
        gen=GEN, requests=REQUESTS, spec_tokens=SPEC, drafter="ngram",
        weight_bytes=dict(full_precision=sum(t.numel() * t.element_size() for t in _leaves(params)),
                          int8_twins_and_scales=int8_bytes),
        kv_bytes=kv_bytes(rep.cache), twins_quantize_s=quantize_s, peak_memory_bytes=peak,
        wall_s=wall, generated_tokens=rep.accepted_total, tok_per_s=rep.accepted_total / wall,
        decode_launches=rep.launches, ms_per_decode_launch=rep.decode_ms / max(rep.launches, 1),
        prefills=rep.prefills, prefill_ms_mean=rep.prefill_ms / max(rep.prefills, 1),
        accepts_per_launch=rep.accepted_total / max(rep.launches, 1),
        accept_rate=rep.accepted_total / max(rep.drafted_total, 1),
        int8_launches_per_decode_launch=per_launch,
        stream_tokens_identical_to_full_width_share=sum(a == b for a, b in pairs) / max(len(pairs), 1),
        kernel_launches=counts, launches_per_step=step,
    )
    while rep.has_work():
        rep.step()
    return out, rep


def admit_twice(dev, params, params8):
    """Admission is bitwise repeatable (kernel 4's fixed-order combine):
    the same 128-token prompt admitted twice into slot 0 of the bf16
    ``full_width`` replica gives bitwise-equal first-token logits and cache
    leaves (k/v, plan_e/plan_w), and again through the int8 replica
    (k/v int8, ks/vs, plans)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.launch.steps import admission

    out = {}
    prompt = serve.synthetic_requests(get_config(ARCH).vocab_size, PROMPT, GEN, 3)[2].prompt
    for tag, quant, p in (("bf16", {}, params), ("int8", dict(kv_dtype="int8", expert_dtype="int8"), params8)):
        cfg = dataclasses.replace(get_config(ARCH), num_layers=LAYERS, decode_plane=True, spec_tokens=SPEC, **quant)
        rep = serve.ServeReplica(cfg, SLOTS, PROMPT + GEN + SPEC, p, drafter="ngram", device=dev)
        reset_launch_counts()
        runs = []
        for _ in range(2):
            logits = admission(rep.model, p, rep.cache, prompt, 0)
            torch.cuda.synchronize()
            runs.append((logits.clone(), [{n: t[0].clone() for n, t in c.items()} for c in rep.cache]))
        counts = launch_counts()
        if counts["down_combine"] != 2 * LAYERS:
            raise AssertionError(f"admit twice {tag}: kernel 4 launches {counts['down_combine']}, not {2 * LAYERS}")
        (l1, c1), (l2, c2) = runs
        if not torch.equal(l1, l2):
            raise AssertionError(f"admit twice {tag}: first-token logits differ "
                                 f"(max |diff| {float((l1 - l2).abs().max()):.3e})")
        for i, (a, b) in enumerate(zip(c1, c2)):
            for n in a:
                if not torch.equal(a[n], b[n]):
                    raise AssertionError(f"admit twice {tag}: layer {i} leaf {n} differs")
        out[tag] = dict(prompt_len=len(prompt), logits_bitwise_equal=True, cache_leaves_bitwise_equal=True,
                        leaves=sorted(c1[0]), down_combine_launches=counts["down_combine"])
        del rep, runs
        torch.cuda.empty_cache()
    return out


def int8_hybrid_window(dev):
    """The hybrid cell over an int8 KV cache: RecurrentGemma-2B uncut on
    ``hybrid_window``'s traffic (:func:`serve_uncut`) with int8 rolling
    buffers and per-slot scales; each decode launch runs kernel 6's int8
    branch in the 8 attention layers and never its full-precision one."""
    served, rep, reqs = serve_uncut(dev, HYBRID, kv_dtype="int8")
    cfg = rep.cfg
    n_attn = cfg.layer_kinds.count("attn")
    counts = served["kernel_launches"]
    if counts["flash_decode_window_int8"] != n_attn * served["decode_launches"] or counts["flash_decode_window"]:
        raise AssertionError(f"int8 hybrid: kernel launches {counts} do not match {served['decode_launches']} "
                             f"decode launches of {n_attn} attention layers")
    step = launches_per_step(rep, reqs[0])
    served.update(attention_layers=n_attn, window_slots=rep.cache[cfg.layer_kinds.index("attn")]["k"].shape[1],
                  int8_launches_per_decode_launch=step["flash_decode_window_int8"]["per_decode_launch"],
                  launches_per_step=step)
    while rep.has_work():
        rep.step()
    del served["streams"]
    return served, rep


def hybrid_window(dev):
    """The hybrid cell: RecurrentGemma-2B uncut (26 layers: 18 RG-LRU, 8
    local attention) on rolling buffers of 2,048 slots (:func:`serve_uncut`):
    every prompt fills its window and every decode write wraps it.  Each
    admission runs kernel 7 in the 8 attention layers and kernel 12 in the
    18 RG-LRU layers; each decode launch runs kernel 6 in the 8 attention
    layers."""
    served, rep, reqs = serve_uncut(dev, HYBRID)
    cfg = rep.cfg
    n_attn, n_rec = cfg.layer_kinds.count("attn"), cfg.layer_kinds.count("rec")
    W = rep.cache[cfg.layer_kinds.index("attn")]["k"].shape[1]
    if W != cfg.local_window or min(len(r.prompt) for r in reqs) < W:
        raise AssertionError(f"hybrid: {W}-slot buffers, prompts {served['prompt_lens']}")
    counts = served["kernel_launches"]
    if (counts["flash_decode_window"] != n_attn * served["decode_launches"]
            or counts["flash_attention"] != n_attn * H_REQUESTS or counts["rglru_scan"] != n_rec * H_REQUESTS):
        raise AssertionError(f"hybrid: kernel launches {counts} do not match {served['decode_launches']} decode "
                             f"launches and {H_REQUESTS} admissions of {n_attn} attention and {n_rec} RG-LRU layers")
    served.update(attention_layers=n_attn, rglru_layers=n_rec, window=cfg.local_window, window_slots=W,
                  decode_matches_prefill=decode_matches_prefill(
                      dev, HYBRID, 3, {"flash_decode_window": 1 * 4, "flash_attention": 1 * 5, "rglru_scan": 2 * 5}))
    served["launches_per_step"] = launches_per_step(rep, reqs[0])
    while rep.has_work():
        rep.step()
    return served, rep


def ssm_serve(dev):
    """The SSM cell: Mamba-2-2.7B uncut (64 SSD layers) on the hybrid cell's
    traffic (:func:`serve_uncut`).  Each admission runs kernel 11 once a
    layer; a decode launch runs no kernel: one recurrent step in plain
    tensor ops, as the reference has no decode kernel."""
    served, rep, reqs = serve_uncut(dev, SSM)
    cfg = rep.cfg
    n_ssm = cfg.layer_kinds.count("ssm")
    counts = served["kernel_launches"]
    if counts["ssd_scan"] != n_ssm * H_REQUESTS or sum(counts.values()) != counts["ssd_scan"]:
        raise AssertionError(f"ssm: kernel launches {counts} are not {n_ssm} ssd_scan launches for each of "
                             f"{H_REQUESTS} admissions and none else")
    step = launches_per_step(rep, reqs[0])
    if step["ssd_scan"] != dict(per_decode_launch=0, per_admission=n_ssm):
        raise AssertionError(f"ssm: launches per step {step['ssd_scan']}, not {n_ssm} per admission and 0 "
                             f"per decode launch")
    served.update(
        ssm_heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim, ssm_head_dim=cfg.ssm_head_dim,
        ssm_state=cfg.ssm_state, ssm_chunk=cfg.ssm_chunk,
        params=sum(t.numel() for t in _leaves(rep.params)) - rep.params["unembed"].numel(),
        decode_state_bytes=sum(t.numel() * t.element_size() for t in _leaves(rep.cache)),
        launches_per_step=step,
    )
    while rep.has_work():
        rep.step()
    return served, rep


def decode_matches_prefill(dev, arch, layers, expect, prompt_len=2100, steps=4):
    """Decode equals prefill of the extended sequence, at full width in f32
    cut to ``layers`` layers: one ``prompt_len``-token prompt, then
    ``steps`` T = 1 decode launches, each launch's logits held against the
    last-position logits of a prefill of the prompt and the tokens decoded
    so far at 1e-4 of their scale (f32 sums in another order over up to
    7,680 terms).  RecurrentGemma-2B (one super-block, rec rec attn): a
    prompt past the 2,048 window, decode through kernel 6 and one RG-LRU
    step against prefill through kernels 7 and 12.  Mamba-2-2.7B (4
    layers): 8 chunks of 256 and a ragged 52, one SSD step against prefill
    through kernel 11 (chunks of 64).  ``expect`` gives each kernel's
    launches in the run.  With random tied embeddings the echo of the input
    token dominates the argmax, so the logits are compared, not the
    tokens."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype="float32", decode_plane=True)
    model = Model(cfg, device=dev)
    params = model.init(1)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
    max_len = prompt_len + steps + 1
    cache = model.init_cache(1, max_len)
    reset_launch_counts()
    toks = [int(model.prefill(params, prompt[None], cache)[0].argmax())]
    errs = []
    for i in range(steps):
        got = model.decode_tokens(params, cache, [[toks[-1]]], [prompt_len + i], max_len=max_len)[0, 0]
        seq = np.concatenate([prompt, np.asarray(toks, np.int32)])
        want = model.prefill(params, seq[None], model.init_cache(1, max_len))[0]
        errs.append(check_close(f"{arch} decode step {i} vs prefill of {len(seq)} tokens", got, want, 1e-4))
        toks.append(int(got.argmax()))
    counts = {n: c for n, c in launch_counts().items() if c}
    if counts != expect:
        raise AssertionError(f"{arch} decode vs prefill: kernel launches {counts}, expected {expect}")
    del params, cache
    torch.cuda.empty_cache()
    return dict(layers=layers, dtype="float32", prompt_len=prompt_len, steps=steps, max_abs_err=max(errs),
                kernel_launches=counts, tolerance="1e-4 x max(1, max |prefill logit|)")


def compiled_launch(rep, vocab, shared=0, prompt=PROMPT, gen=GEN, n=4):
    """The compiled decode launch against the eager one on a cell's replica
    ``rep`` (compiled): ``rep.B`` fresh requests of the cell's traffic
    admitted (eagerly, as always) and one launch, then ``n`` launches
    through the replica with each launch's inputs recorded (the step's
    ``recorder``).  From a copy of the cache taken before those ``n``, the
    same launches run eagerly (``Model.decode_tokens`` and the argmax read
    back) and replayed (the replica's step): each launch's logits and,
    after the last, every cache leaf must be bitwise equal, and the
    replayed cache bitwise the served one, else this raises.  ms per decode
    launch of each (host clock; each call ends in its read back), its
    device-busy ms a launch from the same launches run again under
    ``torch.profiler`` and the idle share that leaves, the replica's
    capture seconds, its graph pool's bytes, and the host ms of the binding
    check every call of a compiled launch makes (decode step and drafter
    step, with their bound leaves)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    step = rep._decode
    for r in serve.synthetic_requests(vocab, prompt, gen, rep.B, shared):
        rep.admit(r)
    rep.step()
    torch.cuda.synchronize()

    def snapshot():
        return [{k: t.clone() for k, t in c.items()} for c in rep.cache]

    def restore(saved):
        for c, s in zip(rep.cache, saved):
            for k, t in c.items():
                t.copy_(s[k])
        torch.cuda.synchronize()

    before = snapshot()
    inputs = step.recorder = []
    try:
        for _ in range(n):
            rep.step()
    finally:
        step.recorder = None
    torch.cuda.synchronize()
    served = snapshot()

    def launch(mode, tokens, lengths, prev, kw):
        if mode == "eager":
            out = rep.model.decode_tokens(rep.params, rep.cache, tokens, lengths, prev, tree=rep.tree,
                                          max_len=rep.max_len, **kw)
            torch.argmax(out, dim=-1).cpu()
            return out
        step(tokens, lengths, prev, **kw)
        return step.logits

    runs, busy = {}, {}
    for mode in ("eager", "replayed"):
        restore(before)
        ms, logits = [], []
        for args in inputs:
            t0 = time.perf_counter()
            out = launch(mode, *args)
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(out.clone())
        torch.cuda.synchronize()
        runs[mode] = (ms, logits, snapshot())
        # the same launches again under the profiler: device-busy ms a launch
        restore(before)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for args in inputs:
                launch(mode, *args)
            torch.cuda.synchronize()
        busy[mode] = sum(device_time_by_name(prof).values()) / n
    (e_ms, e_logits, e_cache), (r_ms, r_logits, r_cache) = runs["eager"], runs["replayed"]
    for i, (a, b) in enumerate(zip(e_logits, r_logits)):
        if not torch.equal(a, b):
            raise AssertionError(f"compiled launch: launch {i} logits differ eager vs replayed "
                                 f"(max |diff| {float((a - b).abs().max()):.3e})")
    for i, (a, b, c) in enumerate(zip(e_cache, r_cache, served)):
        for k in a:
            if not (torch.equal(a[k], b[k]) and torch.equal(b[k], c[k])):
                raise AssertionError(f"compiled launch: layer {i} leaf {k} differs (eager vs replayed vs served)")
    while rep.has_work():
        rep.step()
    launchers = {"decode": step.launcher}
    if rep.model_drafter is not None:
        launchers["drafter"] = rep.model_drafter._step.launcher
    capture_s = {name: lc.capture_s for name, lc in launchers.items()}
    binding = {}
    for name, lc in launchers.items():
        t0 = time.perf_counter()
        for _ in range(100):
            lc.check_binding()
        binding[name] = dict(ms=(time.perf_counter() - t0) * 10, bound_leaves=len(lc._bound))
    return dict(
        launches=n, key=[str(v) for v in step.key], logits_bitwise_equal=True, cache_leaves_bitwise_equal=True,
        cache_leaves=sum(len(c) for c in rep.cache), eager_ms_each=e_ms, replayed_ms_each=r_ms,
        eager_ms_per_decode_launch=statistics.mean(e_ms), replayed_ms_per_decode_launch=statistics.mean(r_ms),
        eager_device_busy_ms=busy["eager"], replayed_device_busy_ms=busy["replayed"],
        eager_idle_share=max(0.0, 1 - busy["eager"] / statistics.mean(e_ms)),
        replayed_idle_share=max(0.0, 1 - busy["replayed"] / statistics.mean(r_ms)),
        capture_s=capture_s, graph_pool_bytes=rep.graphs.reserved_bytes() if rep.graphs else None,
        kernel_launches_per_replay=step.launcher.replay_launches, binding_check=binding,
    )


def launches_per_step(rep, req) -> dict:
    """Launches of each kernel in one admission of ``req`` and in the decode
    launch that follows it; the replica keeps its remaining work."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    rep.admit(req)
    per_admission = launch_counts()
    reset_launch_counts()
    rep.step()
    return {n: dict(per_decode_launch=c, per_admission=per_admission[n]) for n, c in launch_counts().items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def device_time_by_name(prof) -> dict:
    """Device ms by kernel (or copy) name from a ``torch.profiler`` run,
    counting device-side events only: CPU ops also report the device time
    of the kernels they launched, which would count those kernels twice."""
    from torch.autograd import DeviceType

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
    return by_name


# the symbols of the port's decode kernels (kernels 1, 5 and 6: the split and
# merge launches; kernel 2: its gate/up and down launches and its combine)
DECODE_SYMBOLS = ("decode_split_kernel", "window_split_kernel", "window_merge_kernel", "expert_kernel",
                  "combine_kernel")


def profile_decode(rep, vocab, shared=0, prompt=PROMPT, gen=GEN, n=3):
    """Device time by kernel over a short steady window of ``n`` decode
    launches of ``rep`` (the full-width replica, then the paged-tree one,
    whose queue carries the ``shared``-token system prompt of its cell, then
    the hybrid and the SSM ones with their ``prompt``-token queue): replayed
    CUDA graphs, the replicas being compiled, with the device time of the
    port's decode kernels inside them (``port_decode_kernels_ms``).

    The profiler's own host overhead lengthens the launches it records, so
    the idle share divides the device-busy time per launch by the wall time
    per launch of an unprofiled window of the same length just before it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    for r in serve.synthetic_requests(vocab, prompt, gen, rep.B, shared):
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
    by_name = device_time_by_name(prof)
    if not by_name:
        return dict(measured=False, note="the profiler showed no device time")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # the port's decode kernels by their symbols: device time attributed to
    # each kernel node of a replayed graph
    port = {sym: sum(ms for name, ms in by_name.items() if name.startswith(sym)) for sym in DECODE_SYMBOLS}
    # where the host's time goes: operators by their own host time (the
    # profiler's overhead included), with their call counts
    host = sorted(((ev.key, ev.self_cpu_time_total / 1e3, ev.count) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CPU and ev.self_cpu_time_total > 0), key=lambda h: -h[1])[:12]
    return dict(measured=True, launches=n, wall_ms_unprofiled=plain_wall_ms, wall_ms_profiled=wall_ms,
                device_busy_ms=busy, device_idle_share=max(0.0, 1 - busy / plain_wall_ms),
                device_idle_share_profiled=max(0.0, 1 - busy / wall_ms), top_kernels_ms=dict(top),
                replayed=rep._decode.launcher.graph is not None, port_decode_kernels_ms={k: v for k, v in port.items() if v},
                top_host_ops_ms={name: dict(ms=ms, calls=calls) for name, ms, calls in host})


# ---------------------------------------------------------------------------
# request programs, forks and the fabric
# ---------------------------------------------------------------------------

# the README's JSON-schema program, a literal token-id program (a tool-call
# delimiter's shape: 8 fixed ids), and the README's fork program (join first
# and join all)
JSON_SPEC = {"segments": [{"kind": "json_schema", "schema": {"type": "object", "properties": {
    "a": {"type": "integer", "maxDigits": 2}, "b": {"type": "boolean"}}}}]}
TOKENS_SPEC = {"segments": [{"kind": "tokens", "tokens": [151644, 8948, 198, 2610, 525, 264, 151645, 198]}]}
FORK_SEGMENTS = [{"kind": "json_schema", "schema": {"enum": [17, 42]}}, {"kind": "literal", "text": ";done"}]
# the crash cell: Qwen3-MoE at full widths cut to 1 layer (a checkpoint
# holds every weight: 8.7 GB), 4 slots, 8 requests of 64/96/128 tokens with
# ragged generation lengths, so that requests finish before the crash at
# launch 3 and the requests served after it sit beside other neighbours
FABRIC_LAYERS, FABRIC_GENS = 1, (8, 2, 8, 3, 8, 2, 8, 5)


def program_run(rep, reqs, tag, spec, path):
    """Serve ``reqs`` (each carrying ``spec``, or none) through the drained
    replica ``rep`` and gate the run: every request answered, no token
    outside its automaton's allowed set, every constrained stream a word of
    its grammar (or, unconstrained, GEN + 1 tokens), every kernel of
    ``path`` launched.  Returns the run's record (with its streams) and
    leaves ``rep`` drained and reset."""
    import torch

    from repro_torch.core.programs import compile_program
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    reset_launch_counts()
    t0 = time.perf_counter()
    results = serve.serve_queue(rep, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    streams = {rid: r.tokens for rid, r in results.items()}
    if sorted(streams) != sorted(r.rid for r in reqs) or any(r.error for r in results.values()):
        raise AssertionError(f"{tag}: unanswered or failed requests: {results}")
    if rep.prog_masked_emissions:
        raise AssertionError(f"{tag}: {rep.prog_masked_emissions} tokens emitted outside their allowed sets")
    if spec is None:
        if any(len(t) != GEN + 1 for t in streams.values()):
            raise AssertionError(f"{tag}: short streams {streams}")
    else:
        auto = compile_program(spec, rep.cfg.vocab_size).automaton
        for rid, res in results.items():
            for s in res.branches or [res.tokens]:
                if not auto.accepts(s):
                    raise AssertionError(f"{tag}: request {rid} stream {s} is not accepted by its automaton")
    if min(counts[n] for n in path) <= 0:
        raise AssertionError(f"{tag}: a kernel of its path never launched: {counts}")
    out = dict(
        requests=len(reqs), wall_s=wall, generated_tokens=rep.accepted_total, tok_per_s=rep.accepted_total / wall,
        decode_launches=rep.launches, ms_per_decode_launch=rep.decode_ms / max(rep.launches, 1),
        accepts_per_launch=rep.accepted_total / max(rep.launches, 1),
        prefills=rep.prefills, prefill_ms_mean=rep.prefill_ms / max(rep.prefills, 1),
        kernel_launches=counts, streams=streams,
    )
    if rep.model_drafter is not None:
        out["drafter_launches"] = rep.model_drafter.launches
    if spec is not None:
        out.update(
            forks_started=rep.forks_started, forks_live_max=rep.forks_live_max,
            fork_kv_rows_copied=rep.fork_kv_rows_copied, prog_tokens=rep.prog_tokens, prog_masked_emissions=rep.prog_masked_emissions,
            states_visited=len(rep.prog_states_seen), masked_nodes=rep.prog_mask_cnt,
            masked_fraction=rep.prog_mask_frac_sum / max(rep.prog_mask_cnt, 1),
            verify_launches=rep.verify_launches, verify_ms_per_launch=rep.verify_ms / max(rep.verify_launches, 1),
            stream_lens=sorted(len(t) for t in streams.values()),
        )
    if rep.paged:
        out["paged"] = rep.paged_stats()
    rep.reset()
    return out


def masked_verify_cost(rep, spec):
    """The masked verify alone on the card at a full launch's shape: every
    node of every slot (B * T rows of the last launch's logits, the
    compiled program's start state), its device ms a call by the profiler,
    its ms a call by CUDA events (the host's issue of its five operations
    and two uploads included) and by the host clock with the ids read
    back."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import masked_argmax_rows

    table = rep._compiled_program(spec)
    logits = rep._decode.logits.reshape(rep.B * rep.T, -1)
    rows = np.arange(rep.B * rep.T)
    states = np.full(rep.B * rep.T, table.automaton.start)

    def call():
        return masked_argmax_rows(logits, table.allowed, rows, states)

    want = torch.where(table.allowed[states[0]], logits.float(), torch.finfo(torch.float32).min)
    if not torch.equal(call(), torch.argmax(want, -1)):
        raise AssertionError("masked verify: the card's ids differ from the argmax of the masked logits")
    call()
    torch.cuda.synchronize()
    n = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    busy = sum(device_time_by_name(prof).values())
    t0 = time.perf_counter()
    for _ in range(n):
        call().cpu()  # as the serve loop takes it: the ids read back
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    nbytes = rows.size * logits.shape[1] * (4 + 1)  # each masked row's logits and allowed flags, read once
    return dict(rows=int(rows.size), vocab=int(logits.shape[1]), device_ms=busy / n if busy else None,
                event_ms=time_ms(call), host_ms_with_read_back=host_ms, bytes_read=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, allowed_table_bytes=table.nbytes)


def programs(dev, params, params8):
    """Request programs at full width on the 4-layer cut with
    ``full_width``'s traffic (4 slots, 8 requests of 64/96/128 tokens, 32
    generated): (a) contiguous at spec 4 with the ngram drafter, unconstrained,
    under the README's JSON-schema program and under a literal token-id
    program; (b) paged, tree 2,1, the model drafter (the target's first
    layer), unconstrained, JSON steered and JSON unsteered (streams must be
    identical); (c) the same on the int8 plane, unconstrained and JSON.
    Each replica warms up on one programmed request first (its graphs
    captured, the program compiled: compile seconds at vocabulary 151,936).
    Then ``forks`` on (b)'s replica: 8 requests behind the 64-token shared
    prompt, fork 2, join first and join all; no prompt row may be copied
    for a full page.  Returns (programs record, forks record)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.plans import TreePlan
    from repro_torch.launch import serve

    tree = TreePlan.from_branching(TREE)
    base = dataclasses.replace(get_config(ARCH), num_layers=LAYERS, decode_plane=True)
    draft = dict(params, layers=params["layers"][:1])
    draft8 = dict(params8, layers=params8["layers"][:1])
    ways = {
        "contiguous_spec4_ngram": (
            dataclasses.replace(base, spec_tokens=SPEC), params, dict(drafter="ngram"), PROMPT + GEN + SPEC, 0,
            CONTIGUOUS_KERNELS, [("unconstrained", None, True), ("json_schema", JSON_SPEC, True),
                                 ("token_literal", TOKENS_SPEC, True)]),
        "paged_tree2x1_model": (
            dataclasses.replace(base, spec_tokens=tree.num_nodes, paged=True, page_size=PAGE), params,
            dict(tree=tree, drafter="model", drafter_params=draft), PAGED_MAX_LEN, SHARED, PAGED_KERNELS,
            [("unconstrained", None, True), ("json_schema_steered", JSON_SPEC, True),
             ("json_schema_unsteered", JSON_SPEC, False)]),
        "int8_paged_tree2x1_model": (
            dataclasses.replace(base, spec_tokens=tree.num_nodes, paged=True, page_size=PAGE, kv_dtype="int8",
                                expert_dtype="int8"), params8,
            dict(tree=tree, drafter="model", drafter_params=draft8), PAGED_MAX_LEN, SHARED,
            int8_path(PAGED_KERNELS), [("unconstrained", None, True), ("json_schema", JSON_SPEC, True)]),
    }
    out, fork_rep = {}, None
    for way, (cfg, p, kw, max_len, shared, path, runs) in ways.items():
        rep = serve.ServeReplica(cfg, SLOTS, max_len, p, device=dev, **kw)
        serve.serve_queue(rep, serve.synthetic_requests(cfg.vocab_size, PROMPT, 4, 1, shared, JSON_SPEC))
        rep.reset()
        torch.cuda.synchronize()
        row = {}
        for tag, spec, steer in runs:
            rep.steer_drafter = steer
            reqs = serve.synthetic_requests(cfg.vocab_size, PROMPT, GEN, REQUESTS, shared, spec)
            row[tag] = program_run(rep, reqs, f"programs {way} {tag}", spec, path)
            if spec is not None:
                row[tag]["allowed_table_bytes"] = rep._compiled_program(spec).nbytes
        row["compile_s"] = {json.loads(k)["segments"][0]["kind"]: v for k, v in rep.compile_s.items()}
        if "json_schema_unsteered" in row:
            if row["json_schema_steered"]["streams"] != row["json_schema_unsteered"]["streams"]:
                raise AssertionError(f"programs {way}: steered and unsteered streams differ")
            row["steered_streams_equal_unsteered"] = True
        row["masked_verify_alone"] = masked_verify_cost(rep, JSON_SPEC)
        for r in row.values():
            if isinstance(r, dict):
                r.pop("streams", None)
        out[way] = row
        if way == "paged_tree2x1_model":
            fork_rep = rep
        del rep
        torch.cuda.empty_cache()
    forks = {}
    for join in ("first", "all"):
        spec = {"fork": 2, "join": join, "segments": FORK_SEGMENTS}
        reqs = serve.synthetic_requests(base.vocab_size, PROMPT, GEN, REQUESTS, SHARED, spec)
        row = program_run(fork_rep, reqs, f"forks join {join}", spec, PAGED_KERNELS)
        row.pop("streams")
        # a later branch writes only its partial last page: no prompt row of a full page is copied
        partial = sum(len(r.prompt) % PAGE for r in reqs)
        if row["fork_kv_rows_copied"] != partial or row["forks_started"] != REQUESTS:
            raise AssertionError(f"forks join {join}: {row['forks_started']} forks copied "
                                 f"{row['fork_kv_rows_copied']} rows, not {partial}")
        row.update(prompt_lens=sorted({len(r.prompt) for r in reqs}), page_size=PAGE,
                   full_page_prompt_rows=sum(len(r.prompt) - len(r.prompt) % PAGE for r in reqs),
                   expected_fork_rows_copied=partial)
        forks[join] = row
    return out, forks


class CrashProbe:
    """The fault hook of ``fabric_crash``: the injector's verdict, with the
    card's allocated bytes and the answered requests read just before the
    injected crash, the allocated bytes at the rebuilt replica's second
    launch (its graphs captured by then), the slot layout (each slot's
    request id) of every launch, and a weak reference to each replica the
    factory builds (the dead one must be freed, nothing else may keep it)."""

    def __init__(self, injector):
        import weakref

        self.injector, self.weakref = injector, weakref.ref
        self.fabric = None
        self.built = []  # weak references, in build order
        self.layouts = []  # (build, slot layout) of every launch
        self.before_crash = self.after_rejoin = self.answered_before_crash = self.crash_round = None
        self.graphs_after_rejoin = self.dead_freed_at_rejoin = None

    def check(self, replica, step, phase="launch", rids=()):
        import torch

        if phase == "launch":
            rep = self.built[-1]()
            self.layouts.append((len(self.built), tuple(r.rid if r is not None else None for r in rep.requests)))
            del rep
        if phase == "launch" and len(self.built) == 1 and step == 3:
            torch.cuda.synchronize()
            self.before_crash = torch.cuda.memory_allocated()
            self.answered_before_crash, self.crash_round = len(self.fabric.results), self.fabric.round
        if phase == "launch" and len(self.built) == 2 and step == 2 and self.after_rejoin is None:
            torch.cuda.synchronize()
            self.after_rejoin = torch.cuda.memory_allocated()
            self.dead_freed_at_rejoin = self.built[0]() is None  # no collection forced
            rep = self.built[1]()
            launchers = [rep._decode.launcher] + ([rep._commit.launcher] if rep._commit else [])
            self.graphs_after_rejoin = sum(lc.graph is not None for lc in launchers)
        return self.injector.check(replica, step, phase, rids)

    def lives(self) -> dict:
        """Each request's launches in the build that answered it: the slot
        layout of each, its own slot first."""
        out = {}
        for build, layout in self.layouts:
            for rid in layout:
                if rid is not None:
                    life = out.setdefault(rid, [build, []])
                    if life[0] != build:
                        out[rid] = life = [build, []]
                    life[1].append((layout.index(rid), layout))
        return {rid: life for rid, (_, life) in out.items()}


def fabric_crash(dev):
    """The in-process fabric on the card: Qwen3-MoE at full widths cut to 1
    layer (a checkpoint holds every weight: 8.7 GB), 4 slots, spec 4, ngram,
    8 requests of 64/96/128 tokens generating 2 to 8 tokens
    (``FABRIC_GENS``), served through ``ServeFabric`` with one replica
    twice: without faults, then with ``crash@step=3``,
    ``checkpoint_every=2`` and a ``CheckpointManager`` in a temporary
    directory (deleted at the end).  The crash drops the replica; the
    rebuilt one restores its weights from the checkpoint and captures its
    graphs again.  The gate needs the saves up to the one restored; every
    save after the first links the unchanged weight files.  Gates: the two
    runs' streams byte-identical; a request answered before the crash, and
    a request whose launches ran beside other neighbours or in another
    slot than in the clean run (else the gate could not see a row that
    depends on its batch); crashes 1, rejoins 1, restores >= 1, dropped 0,
    duplicates 0; the dead replica freed by the time the rebuilt one
    launches (no collection forced: nothing keeps a reference to it)."""
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.runtime.fabric import FabricConfig, ServeFabric
    from repro_torch.runtime.faults import FaultInjector, parse_faults

    cfg = dataclasses.replace(get_config(ARCH), num_layers=FABRIC_LAYERS, decode_plane=True, spec_tokens=SPEC)
    t0 = time.perf_counter()
    params = Model(cfg, device=dev).init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    max_len = PROMPT + max(FABRIC_GENS) + SPEC
    ladder = serve.degrade_ladder(None, SPEC)
    reqs = [dataclasses.replace(r, gen=g) for r, g in zip(
        serve.synthetic_requests(cfg.vocab_size, PROMPT, max(FABRIC_GENS), len(FABRIC_GENS)), FABRIC_GENS)]
    runs, lives = {}, {}
    with tempfile.TemporaryDirectory(prefix="fabric_crash_") as tmp:
        for tag, faults in (("clean", ""), ("crash", "crash@step=3")):
            probe = CrashProbe(FaultInjector(parse_faults(faults)))
            ckpt = CheckpointManager(tmp, keep=2, cfg=cfg) if faults else None
            make = serve.make_replica_factory(cfg, SLOTS, max_len, params, ladder, fault_hook=probe.check,
                                              launch_timeout=30.0, device=dev)

            def build(w, level, params_=None, shrunk=False, make=make, probe=probe):
                rep = make(w, level, params_, shrunk)
                probe.built.append(probe.weakref(rep))
                return rep

            fabric = ServeFabric(
                build, list(reqs),
                FabricConfig(n_replicas=1, launch_timeout=30.0, checkpoint_every=2 if faults else 0,
                             max_degrade_level=len(ladder) - 1, synthetic_step_times=True),
                ckpt=ckpt, restore_params=(lambda mgr: mgr.restore(dev)[0]) if ckpt else None, params=params)
            probe.fabric = fabric
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = fabric.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            probe.fabric = None
            st = fabric.stats
            if any(r.error for r in results.values()) or len(results) != len(reqs):
                raise AssertionError(f"fabric {tag}: unanswered or failed requests: {results}")
            row = dict(wall_s=wall, generated_tokens=st["accepted"], tok_per_s=st["accepted"] / wall,
                       launches=st["launches"], prefills=st["prefills"], rounds=fabric.round,
                       **{k: st[k] for k in ("crashes", "rejoins", "rewarm_prefills", "restores", "checkpoints",
                                             "dropped", "duplicates")},
                       streams={rid: r.tokens for rid, r in results.items()})
            if ckpt is not None:
                row.update(saves=[dict(step=s, seconds=sec, bytes=b, bytes_written=w)
                                  for s, sec, b, w in ckpt.saves],
                           crash_round=probe.crash_round,
                           saves_until_restore=sum(s <= ckpt.restores[0][0] for s, *_ in ckpt.saves),
                           restores_log=[dict(step=s, seconds=sec, bytes=b) for s, sec, b in ckpt.restores],
                           answered_before_crash=probe.answered_before_crash,
                           memory_allocated_before_crash=probe.before_crash,
                           memory_allocated_after_rejoin=probe.after_rejoin,
                           graphs_captured_after_rejoin=probe.graphs_after_rejoin,
                           dead_replica_freed=probe.dead_freed_at_rejoin)
            runs[tag], lives[tag] = row, probe.lives()
            del fabric, results, make, build, probe
    # the device-to-host half of a save: every weight copied to pageable host memory once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [t.cpu() for t in _leaves(params)]
    weights_to_host_s = time.perf_counter() - t0
    del host
    clean, crash = runs["clean"], runs["crash"]
    if crash["streams"] != clean["streams"]:
        rid = min(r for r in clean["streams"] if clean["streams"][r] != crash["streams"].get(r))
        raise AssertionError(f"fabric crash: request {rid} stream {crash['streams'].get(rid)} after the crash != "
                             f"{clean['streams'][rid]} without it")
    moved = sorted(rid for rid in lives["clean"] if lives["clean"][rid] != lives["crash"].get(rid))
    slot_moved = sorted(rid for rid in lives["clean"]
                        if {b for b, _ in lives["clean"][rid]} != {b for b, _ in lives["crash"].get(rid, [])})
    crash.update(requests_beside_other_neighbours=moved, requests_in_other_slot=slot_moved)
    if not crash["answered_before_crash"] or not moved:
        raise AssertionError(f"fabric crash: the crashed run repeats the clean run's batches "
                             f"({crash['answered_before_crash']} answered before the crash, {moved} served beside "
                             "other neighbours): the gate sees nothing")
    if (crash["crashes"], crash["rejoins"], crash["dropped"], crash["duplicates"]) != (1, 1, 0, 0) \
            or crash["restores"] < 1 or clean["crashes"] or clean["dropped"] or clean["duplicates"]:
        raise AssertionError(f"fabric crash: stats {crash} (clean run {clean})")
    if not crash["dead_replica_freed"] or (torch.device(dev).type == "cuda" and not crash["graphs_captured_after_rejoin"]):
        raise AssertionError(f"fabric crash: dead replica still referenced or no graph captured after the rejoin: "
                             f"{crash}")
    for row in runs.values():
        row.pop("streams")
    return dict(layers=FABRIC_LAYERS, slots=SLOTS, requests=len(reqs), gens=list(FABRIC_GENS), spec_tokens=SPEC,
                weight_bytes=weight_bytes, init_s=init_s, weights_to_host_s=weights_to_host_s,
                streams_byte_identical=True, **runs)


def smoke_twin_programs(dev):
    """The f32 smoke twins with request programs, on the card and on the CPU
    from the same weights: the spec-4 chain under the JSON-schema program,
    the paged tree 2,1 with the model drafter, steered, and a 2-way fork
    (join all) on the paged plane.  Streams (and fork branches) identical,
    no masked emission, the guided drafter and the masked verify run on
    the card."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.plans import TreePlan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    fork = {"fork": 2, "join": "all", "segments": FORK_SEGMENTS}
    runs = {
        "spec4_ngram_json": dict(spec=4, program=JSON_SPEC),
        "paged_tree2x1_model_steered_json": dict(spec=4, tree=(2, 1), drafter="model", ps=8, program=JSON_SPEC),
        "paged_tree2x1_fork2_all": dict(spec=4, tree=(2, 1), ps=8, program=fork),
    }
    out = {}
    for name, r in runs.items():
        tree = TreePlan.from_branching(r["tree"]) if "tree" in r else None
        drafter = r.get("drafter", "ngram")
        cfg = dataclasses.replace(get_smoke_config(ARCH), decode_plane=True, spec_tokens=r["spec"],
                                  paged=bool(r.get("ps")), page_size=r.get("ps") or 16)
        params_cpu = Model(cfg, device="cpu").init(0)
        draft_cpu = dict(params_cpu, layers=params_cpu["layers"][:1]) if drafter == "model" else None
        reqs = serve.synthetic_requests(cfg.vocab_size, 12, 24, 6, 0, r["program"])
        max_len = 12 + 24 + r["spec"]
        kw = dict(tree=tree, drafter=drafter)
        reset_launch_counts()
        rep = serve.ServeReplica(cfg, 3, max_len, _to(params_cpu, dev), device=dev, drafter_params=_to(draft_cpu, dev),
                                 **kw)
        gpu = serve.serve_queue(rep, reqs)
        torch.cuda.synchronize()
        counts = launch_counts()
        cpu_rep = serve.ServeReplica(cfg, 3, max_len, params_cpu, device="cpu", drafter_params=draft_cpu, **kw)
        cpu = serve.serve_queue(cpu_rep, reqs)
        g = {rid: (res.tokens, res.branches) for rid, res in gpu.items()}
        c = {rid: (res.tokens, res.branches) for rid, res in cpu.items()}
        tag = f"smoke twin programs {name}"
        if g != c:
            rid = min(i for i in g if g[i] != c.get(i))
            raise AssertionError(f"{tag}: request {rid}: card {g[rid]} != CPU {c.get(rid)}")
        if len(g) != len(reqs) or rep.prog_masked_emissions or not rep.verify_launches:
            raise AssertionError(f"{tag}: {len(g)} answers, {rep.prog_masked_emissions} masked emissions, "
                                 f"{rep.verify_launches} masked verifies")
        path = PAGED_KERNELS if r.get("ps") else CONTIGUOUS_KERNELS
        if min(counts[n] for n in path) <= 0:
            raise AssertionError(f"{tag}: a kernel of its path never launched: {counts}")
        out[name] = dict(streams_identical=True, requests=len(g), decode_launches=rep.launches,
                         verify_launches=rep.verify_launches, accepted_total=rep.accepted_total,
                         drafted_total=rep.drafted_total, prog_tokens=rep.prog_tokens,
                         forks_started=rep.forks_started, fork_kv_rows_copied=rep.fork_kv_rows_copied,
                         stream_lens=sorted(len(t) for t, _ in g.values()), launches=counts)
    return out


# ---------------------------------------------------------------------------


KERNELS = {
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention/decode.py:162"),
    "decode_moe": ("src/repro_torch/csrc/moe_decode.cu", "src/repro/kernels/moe_decode/kernel.py:86"),
    "gather_swiglu": ("src/repro_torch/csrc/moe_fused.cu",
                      "src/repro/kernels/moe_fused/kernel.py:93"),
    "down_combine": ("src/repro_torch/csrc/moe_fused.cu",
                     "src/repro/kernels/moe_fused/kernel.py:175"),
    "flash_decode_paged": ("src/repro_torch/csrc/flash_decode.cu",
                           "src/repro/kernels/flash_attention/decode.py:379"),
    "flash_decode_window": ("src/repro_torch/csrc/flash_decode.cu",
                            "src/repro/kernels/flash_attention/decode.py:294"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:97"),
    "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu", "src/repro/kernels/rglru_scan/kernel.py:46"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan/kernel.py:65"),
    "grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu", "src/repro/kernels/grouped_gemm/kernel.py:40"),
    "moe_dispatch": ("src/repro_torch/csrc/moe_dispatch.cu", "src/repro/kernels/moe_dispatch/kernel.py:36"),
    "moe_combine": ("src/repro_torch/csrc/moe_dispatch.cu", "src/repro/kernels/moe_dispatch/kernel.py:80"),
    "flash_decode_int8": ("src/repro_torch/csrc/flash_decode.cu",
                          "src/repro/kernels/flash_attention/decode.py:162"),
    "decode_moe_int8": ("src/repro_torch/csrc/moe_decode.cu", "src/repro/kernels/moe_decode/kernel.py:86"),
    "flash_decode_paged_int8": ("src/repro_torch/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_attention/decode.py:379"),
    "flash_decode_window_int8": ("src/repro_torch/csrc/flash_decode.cu",
                                 "src/repro/kernels/flash_attention/decode.py:294"),
}
EP_ONLY = ("grouped_gemm", "moe_dispatch", "moe_combine")


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
    twin8 = smoke_twin(dev, names=["int8_spec4_ngram", "int8_paged_tree2x1_model_shared16", "int8_hybrid_spec1"])
    emit("smoke_twin_int8", **twin8)
    emit("smoke_twin_programs", **smoke_twin_programs(dev))
    torch.cuda.empty_cache()

    # the compiled decode launch held against the eager one in every cell
    graphs = {}
    served, rep = full_width(dev)
    emit("full_width", **served)
    graphs["full_width"] = compiled_launch(rep, cfg.vocab_size)
    emit("profile", **profile_decode(rep, cfg.vocab_size))
    params = rep.params
    del rep  # free the contiguous replica's cache; its weights serve the paged cell
    torch.cuda.empty_cache()
    paged, rep = paged_tree(dev, params)
    emit("paged_tree", **paged)
    graphs["paged_tree"] = compiled_launch(rep, cfg.vocab_size, SHARED)
    emit("profile_paged", **profile_decode(rep, cfg.vocab_size, SHARED))
    del rep
    torch.cuda.empty_cache()
    ep, ep_twin, ep_prof, graphs["expert_parallel"] = expert_parallel(dev, params, served)
    emit("expert_parallel", **ep)
    emit("smoke_twin_ep", **ep_twin)
    emit("profile_ep", **ep_prof)
    int8, rep = int8_full_width(dev, params, served)
    emit("int8_full_width", **int8)
    graphs["int8_full_width"] = compiled_launch(rep, cfg.vocab_size)
    emit("profile_int8", **profile_decode(rep, cfg.vocab_size))
    params8 = rep.params
    del rep
    torch.cuda.empty_cache()
    paged8, rep = paged_tree(dev, params8, int8=True)
    emit("int8_paged_tree", **paged8)
    graphs["int8_paged_tree"] = compiled_launch(rep, cfg.vocab_size, SHARED)
    del rep
    torch.cuda.empty_cache()
    emit("admit_twice", **admit_twice(dev, params, params8))
    progs, forks = programs(dev, params, params8)
    emit("programs", **progs)
    emit("forks", **forks)
    del params, params8  # free the MoE weights before the crash cell and the hybrid cell
    torch.cuda.empty_cache()
    emit("fabric_crash", **fabric_crash(dev))
    torch.cuda.empty_cache()
    hybrid, rep = hybrid_window(dev)
    emit("hybrid_window", **hybrid)
    graphs["hybrid_window"] = compiled_launch(rep, get_config(HYBRID).vocab_size, prompt=H_PROMPT, gen=H_GEN)
    emit("profile_hybrid", **profile_decode(rep, get_config(HYBRID).vocab_size, prompt=H_PROMPT, gen=H_GEN, n=5))
    del rep
    torch.cuda.empty_cache()
    hybrid8, rep = int8_hybrid_window(dev)
    emit("int8_hybrid_window", **hybrid8)
    graphs["int8_hybrid_window"] = compiled_launch(rep, get_config(HYBRID).vocab_size, prompt=H_PROMPT, gen=H_GEN)
    del rep  # free the hybrid weights before the SSM cell
    torch.cuda.empty_cache()
    ssm, rep = ssm_serve(dev)
    emit("ssm_serve", **ssm)
    emit("ssm_decode_matches_prefill", **decode_matches_prefill(dev, SSM, 4, {"ssd_scan": 4 * 5}))
    graphs["ssm_serve"] = compiled_launch(rep, get_config(SSM).vocab_size, prompt=H_PROMPT, gen=H_GEN)
    emit("profile_ssm", **profile_decode(rep, get_config(SSM).vocab_size, prompt=H_PROMPT, gen=H_GEN))
    del rep
    emit("compiled_launch", **graphs)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        # each kernel's launches come from the serving path it belongs to
        path = (paged if name == "flash_decode_paged" else hybrid if name in HYBRID_KERNELS
                else ssm if name in SSM_KERNELS else ep if name in EP_ONLY
                else int8 if name in ("flash_decode_int8", "decode_moe_int8")
                else paged8 if name == "flash_decode_paged_int8"
                else hybrid8 if name == "flash_decode_window_int8" else served)
        counts = path.get("kernel_launches", path)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
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
