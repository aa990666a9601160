#!/usr/bin/env python3
"""Kernel 7's backward (``csrc/flash_attention_bwd.cu``) timed on the card
in the forms its tensor-core build can take at hd 256, beside other
checkouts' builds and SDPA's backward, at each training head dim.

    python3 tools/fa_bwd_variants.py [--csrc parent=build/parent/src/repro_torch/csrc ...] \
        [--only shipped,...] [--hd 64,96,128,160,256]

Builds, with the package's flags, into ``build/fa_bwd_variants/``:

* ``shipped``: this tree's source (at hd 256, dK/dV: two warpgroups a block
  over the same keys, one keeping dV and one dK; dQ: two warpgroups a block
  over consecutive rows in 32-key steps, sharing each K/V stage);
* ``two launches``: the hd 256 dK/dV launch as two launches of the
  one-warpgroup template, one keeping dV and one dK (each reads every
  Q / dO tile);
* ``dkv BQ 32``: the shipped form with 32 query positions a dK/dV step
  instead of 64 at hd 256;
* ``dq one warpgroup``: the hd 256 dQ launch with one warpgroup a block;
* ``dkv and dq decoupled``: a warpgroup may run up to a step ahead of the
  other (each warp releases a stage on an mbarrier; a thread of the slower
  warpgroup refills it), where the shipped build holds every warp of a
  block at a barrier at the end of each step;
* ``masked every step``: the mask computed on every step, where the
  shipped build skips it on steps whose pairs are all visible;
* ``ex2.approx.ftz``: P's exponentials by one ``ex2.approx.ftz.f32`` each
  (denormal results flushed to 0), where the shipped build calls
  ``exp2f``;
* ``lo halves zeroed``: the shipped source with the lo halves of P and dS
  set to 0 (bf16 P and dS alone), to count what they buy;
* each ``--csrc TAG=DIR``: another checkout's ``flash_attention_bwd.cu``,
  launched through its tensor-core entry where that takes the head dim,
  else through its CUDA-core entry.

``--only`` picks the builds of this tree's source (default: all).  Each
build is held by the gate at small ragged shapes (hd 256 at G 10, 4 and 1,
causal, windowed and full; the shipped source also at hd 64, 128 and 160),
then timed at each head dim of ``--hd`` (default 256) at its training
row's shape in ``chip_smoke.py``: hd 256 RecurrentGemma-2B's heads (10 / 1)
at batch 2 under its 2,048-token window; hd 128 StarCoder2-3B's (24 / 2) at
batch 4; hd 64, 96 and 160 MusicGen-large's (32 / 32), Phi-3-Vision's
(32 / 32) and StableLM-12B's (32 / 8) at batch 1; causal 2,048-token bf16
sequences from a seed.  There: misses of row 7's bf16 gate against the
plain backward on the LSE forward's O and lse, bitwise on a repeat, the
profiler's device ms a call and by launch, and CUDA-event ms, in two
rounds in opposite orders, with SDPA's backward (``is_causal``, kv heads
expanded) timed in each round; registers, spills and a SASS census of each
build's hd 256 kernels.  One JSON line a measurement; all also go to
``chiprun_out/fa_bwd_variants.json``.  Needs the card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import variant_builds as vb

DKV_LAUNCH = "launch_dkv<HD, Dkv<HD>::ROLES>("
LO_LINE = "lo = *reinterpret_cast<const uint32_t*>(&l);"
BQ_LINE = "static constexpr int BQ = HD == 160 ? 32 : 64;"
DQ_WG_LINE = "static constexpr int WG = HD > 160 ? 2 : 1;"
# a warpgroup may run up to a step ahead of the other: each warp releases a
# stage on an mbarrier of its own and a thread of the slower (dK, or the last)
# warpgroup refills it, where the shipped source holds every warp at a block
# barrier at the end of each step
DECOUPLE_BARS = {
    "    for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + 8 * i, 1);\n":
        "    for (int i = 0; i < 3; ++i) sm90::mbar_init(bars + 8 * i, 1);\n"
        "    for (int i = 3; i < 5; ++i) sm90::mbar_init(bars + 8 * i, blockDim.x / 32);\n",
}
DKV_DECOUPLED = {
    "  static constexpr int BAR = KV + 2 * STAGE;\n  static constexpr int BYTES = BAR + 3 * 8 + 1024;":
        "  static constexpr int BAR = KV + 2 * STAGE;\n  static constexpr int BYTES = BAR + 5 * 8 + 1024;",
    "      if (tid == 0 && it + 1 < nsteps) load_q(it + 1);":
        "      if (tid == (ROLES == SPLIT ? THREADS : 0) && it + 1 < nsteps) {\n"
        "        if (it > 0) sm90::mbar_wait(bars + 8 * (4 - st), ((it - 1) >> 1) & 1);\n"
        "        load_q(it + 1);\n      }",
    '      asm volatile("bar.sync 0;\\n" ::: "memory");':
        "      __syncwarp();\n      if (lane == 0) sm90::mbar_arrive(bars + 8 * (3 + st));",
}
DQ_DECOUPLED = {
    "  static constexpr int BAR = WG * QD + 2 * STAGE;\n  static constexpr int BYTES = BAR + 3 * 8 + 1024;":
        "  static constexpr int BAR = WG * QD + 2 * STAGE;\n  static constexpr int BYTES = BAR + 5 * 8 + 1024;",
    "    if (tid == 0 && it + 1 < ntiles) load_kv(it + 1);":
        "    if (tid == (L::WG - 1) * THREADS && it + 1 < ntiles) {\n"
        "      if (it > 0) sm90::mbar_wait(bars + 8 * (4 - st), ((it - 1) >> 1) & 1);\n"
        "      load_kv(it + 1);\n    }",
    "    __syncthreads();  // every warp is done with this stage before it is refilled":
        "    __syncwarp();\n    if (lane == 0) sm90::mbar_arrive(bars + 8 * (3 + st));",
}
ARGS = "(tq, tdo, tk, tv, lse2, dsum, dkp, dvp, B, Sq, Sp, Skv, nq, nkv, causal, window, scale_log2, scale, st)"
VARIANTS = {
    "shipped": {},
    "two launches": {DKV_LAUNCH: f"launch_dkv<HD, KEEP_DV>{ARGS} || launch_dkv<HD, KEEP_DK>("},
    "dkv BQ 32": {BQ_LINE: "static constexpr int BQ = HD >= 160 ? 32 : 64;"},
    "dq one warpgroup": {DQ_WG_LINE: "static constexpr int WG = 1;"},
    "dkv and dq decoupled": {**DECOUPLE_BARS, **DKV_DECOUPLED, **DQ_DECOUPLED},
    "ex2.approx.ftz": {
        "constexpr float LOG2E = 1.4426950408889634f;":
            "constexpr float LOG2E = 1.4426950408889634f;\n"
            "__device__ __forceinline__ float ex2(float x) {\n"
            "  float y;\n"
            '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
            "  return y;\n}",
        "exp2f(s[e] * scale_log2 - lrow[c])": "ex2(s[e] * scale_log2 - lrow[c])",
        "exp2f(s[e] * scale_log2 - l2[i])": "ex2(s[e] * scale_log2 - l2[i])",
    },
    "masked every step": {"const bool inside = p0": "const bool inside = false && p0",
                          "const bool inside = k0": "const bool inside = false && k0"},
    "lo halves zeroed": {LO_LINE: "lo = 0u;"},
}
# the hd 256 kernels' mangled names: the tensor-core dK/dV and dQ kernels,
# an earlier CUDA-core build's bf16 instantiations
KERNEL_NAMES = ("dkv_tc_kernelILi256E", "dq_tc_kernelILi256E", "13__nv_bfloat16Li256E")
LAUNCHES = ("bwd_prep_tc_kernel", "dkv_tc_kernel", "dkv_reduce_kernel", "dq_tc_kernel", "row_dot_kernel",
            "dkv_kernel", "dq_kernel")
# hd -> batch, query heads, kv heads, window of its training row in chip_smoke.py
TIMED = {256: (2, 10, 1, 2048), 128: (4, 24, 2, 0), 64: (1, 32, 32, 0), 96: (1, 32, 32, 0), 160: (1, 32, 8, 0)}
S = 2048


def main() -> int:
    import torch

    from chip_smoke import census_of, check_bf16, device_ms, time_ms
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", default=[], metavar="TAG=DIR",
                    help="another checkout's src/repro_torch/csrc, under the name TAG")
    ap.add_argument("--only", default="", help="comma-separated variants of this tree to build (default: all)")
    ap.add_argument("--hd", default="256", help="comma-separated head dims to time (of %s)" % sorted(TIMED))
    args = ap.parse_args()
    hds = [int(h) for h in args.hd.split(",")]
    assert all(h in TIMED for h in hds), hds
    if not torch.cuda.is_available():
        print("fa_bwd_variants: no CUDA device is available", file=sys.stderr)
        return 1
    out_dir = vb.ROOT / "build" / "fa_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    only = [n for n in args.only.split(",") if n]
    jobs = {name: vb.start(out_dir, name, kernels.CSRC, "flash_attention_bwd.cu", subs, every=True)
            for name, subs in VARIANTS.items() if not only or name in only}
    for spec in args.csrc:
        tag, path = spec.split("=", 1)
        jobs[tag] = vb.start(out_dir, tag, Path(path).resolve(), "flash_attention_bwd.cu")
    rec = vb.Record("fa_bwd_variants")
    libs = {}
    for name, (lib, cdll, log) in vb.finish(jobs).items():
        libs[name] = cdll
        rec.emit(variant=name, ptxas=vb.ptxas(log, *KERNEL_NAMES),
                 warnings=[ln.strip() for ln in log.splitlines() if "warning" in ln.lower()][:20],
                 census=census_of(lib, *KERNEL_NAMES))

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    tc_fn = {}

    def inputs(B, S, nq, nkv, hd, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        q, do = (torch.randn((B, S, nq, hd), generator=g, device=dev).to(bf16) for _ in range(2))
        k, v = (torch.randn((B, S, nkv, hd), generator=g, device=dev).to(bf16) for _ in range(2))
        return q, k, v, do

    def launch(name, q, k, v, out, lse, do, causal, window):
        """A launch of ``name``'s tensor-core entry, or where that refuses
        the head dim, of its CUDA-core entry: (dq, dk, dv)."""
        kernels._LIBS["flash_attention_bwd"] = libs[name]
        B, Sq, nq, hd = q.shape
        Skv, nkv = k.shape[1], k.shape[2]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        scratch = torch.empty((fa_ops.bwd_scratch_floats("tensor_cores", B, Sq, Skv, nq, hd),),
                              dtype=torch.float32, device=dev)
        ptrs = tuple(t.data_ptr() for t in (q, k, v, out, do, lse, scratch, dq, dk, dv))
        shape = (B, Sq, Skv, nq, nkv, hd, int(causal), window, hd ** -0.5, kernels.stream_of(q))
        tc = kernels.function("flash_attention_bwd", "repro_flash_attention_bwd_tc", fa_ops._FA_BWD_TC_ARGTYPES)
        rc = tc(*ptrs, *shape)
        tc_fn[name] = rc == 0
        if rc != 0:
            fn = kernels.function("flash_attention_bwd", "repro_flash_attention_bwd", fa_ops._FA_BWD_ARGTYPES)
            kernels.check_launch(fn(1, *ptrs, *shape), name)
        return dq, dk, dv

    # every build at small ragged shapes: B, S, nq, nkv, hd, causal, window
    small = [(2, 161, 10, 1, 256, True, 0), (1, 100, 10, 1, 256, True, 30), (1, 97, 4, 4, 256, False, 0),
             (2, 150, 8, 2, 256, True, 45), (1, 70, 2, 1, 256, False, 17)]
    others = [(2, 131, 16, 2, 64, True, 0), (2, 150, 24, 2, 128, True, 0), (1, 140, 8, 1, 160, False, 50),
              (2, 211, 8, 2, 160, True, 45)]
    for name in libs:
        for n, (B, Ss, nq, nkv, hd, causal, window) in enumerate(small + (others if name == "shipped" else [])):
            q, k, v, do = inputs(B, Ss, nq, nkv, hd, 10 + n)
            out, lse = fa_ops.flash_attention_lse_kernel(q, k, v, causal=causal, window=window)
            got = launch(name, q, k, v, out, lse, do, causal, window)
            want = fa_ref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
            again = launch(name, q, k, v, out, lse, do, causal, window)
            rec.emit(variant=name, small=[B, Ss, nq, nkv, hd, causal, window], tensor_core_entry=tc_fn[name],
                     misses=[vb.misses(a, w) for a, w in zip(got, want)],
                     bitwise_repeat=all(torch.equal(a, b) for a, b in zip(got, again)))

    for hd in hds:
        B, nq, nkv, window = TIMED[hd]
        q, k, v, do = inputs(B, S, nq, nkv, hd, S + hd)
        out, lse = fa_ops.flash_attention_lse_kernel(q, k, v, causal=True, window=window)
        want = fa_ref.flash_attention_bwd(q, k, v, out, lse, do, causal=True, window=window)
        qt = q.transpose(1, 2).detach().requires_grad_(True)
        kt, vt = (c.transpose(1, 2).repeat_interleave(nq // nkv, 1).detach().requires_grad_(True) for c in (k, v))
        o_lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)

        def sdpa():
            return torch.autograd.grad(o_lib, (qt, kt, vt), dot, retain_graph=True)

        for rnd, order in vb.rounds(list(libs)):
            rec.emit(round=rnd, hd=hd, variant="SDPA's backward (is_causal)", device_ms=device_ms(sdpa, "", n=5),
                     ms=time_ms(sdpa, iters=5, reps=3))
            for name in order:
                def run(name=name):
                    return launch(name, q, k, v, out, lse, do, True, window)

                got = run()
                line = {"round": rnd, "hd": hd, "variant": name, "tensor_core_entry": tc_fn[name],
                        "device_ms": device_ms(run, "", n=5),
                        "device_ms_by_launch": {s: device_ms(run, s, n=3) for s in LAUNCHES},
                        "ms": time_ms(run, iters=5, reps=3), "misses": [vb.misses(a, w) for a, w in zip(got, want)],
                        "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, run()))}
                line["device_ms_by_launch"] = {s: t for s, t in line["device_ms_by_launch"].items() if t}
                if not any(line["misses"]):
                    line["max_abs_err"] = max(check_bf16(f"{name} hd {hd} {g}", a, w)
                                              for g, a, w in zip("qkv", got, want))
                rec.emit(**line)
        del q, k, v, do, out, lse, want, qt, kt, vt, o_lib, dot
        torch.cuda.empty_cache()
    rec.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
