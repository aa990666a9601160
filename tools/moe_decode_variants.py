#!/usr/bin/env python3
"""Kernel 2 (``csrc/moe_decode.cu``) built with other ring shapes, timed by
launch on the card beside the shipped build.

    python3 tools/moe_decode_variants.py

Each variant is the shipped source with some of its constant lines replaced
(K rows a stage, stages, blocks an SM asked of the compiler), built with the
package's flags into ``build/moe_decode_variants/`` and swapped in under the
wrapper.  At the serving shape (16 tokens, top-8 of 128, d 4096, f 1536,
bf16 x, a random plan from a seed) each build runs the bf16 and the int8
stacks; the profiler's device ms of each of the three launches (gate/up,
down, combine) are printed, two rounds in opposite orders, with whether the
output is bitwise the shipped build's (other K rows a stage sum in another
order) and the registers and spills ``ptxas`` reports.  One JSON line a
measurement; all of them also go to ``chiprun_out/moe_decode_variants.json``.
Needs the card.
"""
from __future__ import annotations

import sys

import variant_builds as vb

BK, STAGES, BOUNDS = "constexpr int BK = 64;", "constexpr int STAGES = 3;", "__launch_bounds__(THREADS, 2) expert_kernel("
VARIANTS = {
    "shipped (64 K rows a stage, 3 stages)": {},
    "32 K rows, 4 stages": {BK: "constexpr int BK = 32;", STAGES: "constexpr int STAGES = 4;"},
    "32 K rows, 6 stages": {BK: "constexpr int BK = 32;", STAGES: "constexpr int STAGES = 6;"},
    "16 K rows, 6 stages": {BK: "constexpr int BK = 16;", STAGES: "constexpr int STAGES = 6;"},
    "64 K rows, 3 stages, 3 blocks an SM": {BOUNDS: "__launch_bounds__(THREADS, 3) expert_kernel("},
    "64 K rows, 4 stages": {STAGES: "constexpr int STAGES = 4;"},
    "64 K rows, 6 stages, 1 block an SM": {STAGES: "constexpr int STAGES = 6;",
                                           BOUNDS: "__launch_bounds__(THREADS, 1) expert_kernel("},
}


def main() -> int:
    import torch

    from chip_smoke import moe_decode_launches
    from repro_torch import kernels
    from repro_torch.core.control_plane import route_topk_decode
    from repro_torch.core.quant import quantize_int8
    from repro_torch.kernels.moe_decode import ops as md_ops

    if not torch.cuda.is_available():
        print("moe_decode_variants: no CUDA device is available", file=sys.stderr)
        return 1
    out_dir = vb.ROOT / "build" / "moe_decode_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    rec = vb.Record("moe_decode_variants")
    libs = {}
    for name, (_, lib, log) in vb.finish({name: vb.start(out_dir, name, kernels.CSRC, "moe_decode.cu", subs)
                                          for name, subs in VARIANTS.items()}).items():
        libs[name] = lib
        regs = sorted({int(ln.split("Used")[1].split()[0]) for ln in vb.ptxas(log) if "Used" in ln})
        spills = sorted({ln for ln in vb.ptxas(log) if "spill" in ln and " 0 bytes spill stores" not in ln})
        rec.emit(variant=name, registers=regs, spills=spills)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    T, k, E, d, f = 16, 8, 128, 4096, 1536
    x32 = torch.randn((T, d), generator=g, device=dev)
    plan = route_topk_decode(x32, torch.randn((d, E), generator=g, device=dev) * 0.02, k)
    ids, w, x = plan.expert_ids.contiguous(), plan.weights.contiguous(), x32.to(torch.bfloat16)
    bf16, int8, scales = [], [], []
    for shape, a in (((E, d, f), d ** -0.5), ((E, d, f), d ** -0.5), ((E, f, d), f ** -0.5)):
        s32 = torch.randn(shape, generator=g, device=dev) * a
        bf16.append(s32.to(torch.bfloat16))
        q, s = quantize_int8(s32, axis=(1, 2))
        int8.append(q)
        scales.append(s[:, 0, 0])
        del s32
        torch.cuda.empty_cache()
    scales = torch.stack(scales).contiguous()
    runs = {"bf16": lambda: md_ops.decode_moe_kernel(x, ids, w, *bf16),
            "int8": lambda: md_ops.decode_moe_kernel(x, ids, w, *int8, scales)}
    shipped = {kind: fn() for kind, fn in runs.items()}
    ours = kernels.library("moe_decode")
    names = list(VARIANTS)
    try:
        for rnd, order in vb.rounds(names):
            for name in order:
                kernels._LIBS["moe_decode"] = libs[name]
                for kind, fn in runs.items():
                    by = moe_decode_launches(fn)
                    rec.emit(round=rnd, variant=name, stacks=kind, device_ms=by,
                             device_ms_total=sum(v or 0.0 for v in by.values()),
                             bitwise_shipped=torch.equal(fn(), shipped[kind]))
    finally:
        kernels._LIBS["moe_decode"] = ours
    rec.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
