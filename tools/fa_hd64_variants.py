#!/usr/bin/env python3
"""Kernel 7's tensor-core template at hd 64 (``flash_attention_tc_kernel``
in ``csrc/flash_attention.cu``) timed on the card beside the same template
without its hd 64 cuts, the shipped source with P's lo half zeroed, other
checkouts' builds and SDPA.

    python3 tools/fa_hd64_variants.py [--csrc parent=build/parent/src/repro_torch/csrc ...]

Builds, with the package's flags, into ``build/fa_hd64_variants/``:

* ``shipped``: this tree's source;
* ``plain template``: the same with ``LEAN<HD>`` false everywhere and a
  P.V branch at hd 64 (``wgmma m64n64k16``) in the template's chain: one
  block an SM asked, the template's block order, mask, softmax and packing,
  P.V after the whole softmax (a bf16 hd 64 ``case`` added to the
  template and nothing else);
* ``lo half zeroed``: the shipped source with P's lo half at hd 64 set to
  0 (bf16 P alone), to count what the lo half buys;
* each ``--csrc TAG=DIR``: another checkout's ``flash_attention.cu``,
  launched through its tensor-core entry where that takes hd 64, else
  through its CUDA-core entry.

Each is called through its C entry, at MusicGen-large's heads (32 query
and 32 KV heads of 64), one causal sequence of 2,048 and one of 4,096 bf16
tokens from a seed: misses of the bf16 gate against the plain version, bitwise on a
repeat, the LSE launch's O bitwise the serving launch's (this tree's
build), the profiler's device ms a call and CUDA-event ms, in two rounds
in opposite orders, with SDPA (``is_causal``) timed in each round;
registers, spills and a SASS census of each build's hd 64 kernel.  Every
build is also held by the gate at small ragged shapes (MHA and GQA,
causal, windowed and full).  One JSON line a measurement; all also go to
``chiprun_out/fa_hd64_variants.json``.  Needs the card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import variant_builds as vb

LEAN_LINE = "constexpr bool LEAN = HD == 64;"
PV_CHAIN = "        } else {\n          static_assert(HD == 96,"
PV_HD64 = ("        } else if constexpr (HD == 64) {\n          sm90::wgmma_rs_m64n64k16(o, ah, dv);\n"
           "          sm90::wgmma_rs_m64n64k16(o, al, dv);\n" + PV_CHAIN)
LO_LINE = "pl[x] = pack_bf16(s[2 * x] - h0, s[2 * x + 1] - h1);"
VARIANTS = {
    "shipped": {},
    "plain template": {LEAN_LINE: "constexpr bool LEAN = false;", PV_CHAIN: PV_HD64},
    "lo half zeroed": {LO_LINE: "pl[x] = 0u;"},
}
# the hd 64 kernels' mangled names: the template, an earlier separate
# kernel, the CUDA-core build's bf16 instantiation
KERNEL_NAMES = ("flash_attention_tc_kernelILi64E", "flash_attention_tc64_kernel",
                "flash_attention_kernelI13__nv_bfloat16Li64E")


def main() -> int:
    import torch

    from chip_smoke import census_of, check_bf16, device_ms, time_ms
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", default=[], metavar="TAG=DIR",
                    help="another checkout's src/repro_torch/csrc, under the name TAG")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fa_hd64_variants: no CUDA device is available", file=sys.stderr)
        return 1
    out_dir = vb.ROOT / "build" / "fa_hd64_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: vb.start(out_dir, name, kernels.CSRC, "flash_attention.cu", subs) for name, subs in VARIANTS.items()}
    for spec in args.csrc:
        tag, path = spec.split("=", 1)
        jobs[tag] = vb.start(out_dir, tag, Path(path).resolve(), "flash_attention.cu")
    rec = vb.Record("fa_hd64_variants")
    libs = {}
    for name, (lib, cdll, log) in vb.finish(jobs).items():
        libs[name] = cdll
        rec.emit(variant=name, ptxas=vb.ptxas(log, *KERNEL_NAMES), census=census_of(lib, *KERNEL_NAMES))

    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    def inputs(B, S, nq, nkv, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn((B, S, n, 64), generator=g, device=dev).to(bf16) for n in (nq, nkv, nkv))

    def launch(name, q, k, v, causal, window):
        """A launch of ``name``'s tensor-core entry, or where that refuses
        hd 64, of its CUDA-core entry."""
        kernels._LIBS["flash_attention"] = libs[name]
        B, Sq, nq, hd = q.shape
        out = torch.empty_like(q)
        shape = (B, Sq, k.shape[1], nq, k.shape[2], hd, int(causal), window, hd ** -0.5, kernels.stream_of(q))
        tc = kernels.function("flash_attention", "repro_flash_attention_tc", fa_ops._FA_TC_ARGTYPES)
        if tc(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *shape) == 0:
            return out
        fn = kernels.function("flash_attention", "repro_flash_attention", fa_ops._FA_ARGTYPES)
        kernels.check_launch(fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *shape), name)
        return out

    # every build at small ragged shapes: B, S, nq, nkv, causal, window
    small = [(2, 197, 16, 4, True, 0), (2, 197, 16, 4, True, 45), (2, 197, 16, 4, False, 0),
             (1, 300, 32, 32, True, 45), (1, 131, 10, 1, True, 0), (1, 70, 64, 1, False, 17)]
    for name in libs:
        for n, (B, S, nq, nkv, causal, window) in enumerate(small):
            q, k, v = inputs(B, S, nq, nkv, 10 + n)
            got = launch(name, q, k, v, causal, window)
            want = fa_ref.flash_attention(q, k, v, causal=causal, window=window)
            rec.emit(variant=name, small=[B, S, nq, nkv, causal, window], misses=vb.misses(got, want),
                     bitwise_repeat=torch.equal(got, launch(name, q, k, v, causal, window)))

    names = list(libs)
    for S in (2048, 4096):
        q, k, v = inputs(1, S, 32, 32, S)
        want = fa_ref.flash_attention(q, k, v, causal=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        for rnd, order in vb.rounds(names):
            rec.emit(round=rnd, S=S, variant="SDPA (is_causal)", device_ms=device_ms(sdpa, "", n=20),
                     ms=time_ms(sdpa, iters=20))
            for name in order:
                def run(name=name):
                    return launch(name, q, k, v, True, 0)

                got = run()
                line = {"round": rnd, "S": S, "variant": name, "device_ms": device_ms(run, "flash_attention", n=20),
                        "ms": time_ms(run, iters=20), "misses": vb.misses(got, want),
                        "bitwise_repeat": torch.equal(got, run())}
                if line["misses"] == 0:
                    line["max_abs_err"] = check_bf16(f"{name} S {S}", got, want)
                if name == "shipped":
                    o, _ = fa_ops.flash_attention_lse_kernel(q, k, v, causal=True)
                    line["lse_o_bitwise_serving"] = torch.equal(o, got)
                rec.emit(**line)
        del q, k, v, want, qt, kt, vt
        torch.cuda.empty_cache()
    rec.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
