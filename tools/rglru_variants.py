#!/usr/bin/env python3
"""Kernel 12 (``csrc/rglru_scan.cu``) built with other shapes, in three
launches, and as another checkout's build, timed on the card beside the
shipped build.

    python3 tools/rglru_variants.py [--parent-csrc build/parent/src/repro_torch/csrc]

Each one-launch variant is the shipped source with some of its constant
lines replaced (steps a segment and segments a chunk, so the chunk's
length; which warp publishes; fences beside the flags' release and acquire;
blocks an SM asked of the compiler); ``tools/rglru_three_pass.cu`` is the three-launch form
(aggregates, a fold over chunks a channel, the walk again) on the shipped
source's helpers; ``--parent-csrc`` adds another checkout's
``rglru_scan.cu`` (the C entry without a scratch argument, as before the
chunked scan).  All are built with the package's flags into
``build/rglru_variants/`` and called through their C entries at the hybrid
cell's admission shape, (1, 4096, 2560), with f32 and bf16 gates from a
seed: the profiler's device ms a call (every kernel and memset it issues),
CUDA-event ms, whether the output is bitwise the shipped build's, the
largest difference from the plain version, registers and spills; two
rounds in opposite orders.  One JSON line a measurement; all also go to
``chiprun_out/rglru_variants.json``, with each build's SASS census, and the
SASS of the parent's and the shipped build to ``chiprun_out/rglru_sass_*.txt``.
Needs the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import variant_builds as vb

SEG, WARPS = "constexpr int SEG = 8;", "constexpr int WARPS = 16;"
BOUNDS = "__launch_bounds__(THREADS, 1) rglru_chunk_kernel("
RELEASE = "    __syncwarp();  // the warp's stores before lane 0's release (as CUTLASS's semaphore)"
ACQUIRE = "      __syncwarp();  // each lane's acquire before every lane's reads"
EIGHT, TWO_BLOCKS = {WARPS: "constexpr int WARPS = 8;"}, {BOUNDS: "__launch_bounds__(THREADS, 2) rglru_chunk_kernel("}
# name -> (substitutions in rglru_scan.cu, steps a chunk)
VARIANTS = {
    "shipped (16 segments of 8 steps, 1 block an SM)": ({}, 128),
    "a __threadfence beside each release and acquire": (
        {RELEASE: "    __threadfence();\n" + RELEASE, ACQUIRE: ACQUIRE + "\n      __threadfence();"}, 128),
    "8 segments of 16 steps (chunks of 128)": ({**EIGHT, SEG: "constexpr int SEG = 16;"}, 128),
    "8 segments of 8 steps (chunks of 64), 2 blocks an SM": ({**EIGHT, **TWO_BLOCKS}, 64),
    "8 segments of 4 steps (chunks of 32), 2 blocks an SM": (
        {**EIGHT, **TWO_BLOCKS, SEG: "constexpr int SEG = 4;"}, 32),
}
SHIPPED = next(iter(VARIANTS))
TRACED = "shipped, traced"
THREE = "three launches (form A)"
PARENT = "parent checkout"
ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
PARENT_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def main() -> int:
    import torch

    from chip_smoke import census_of, device_ms, time_ms
    from repro_torch import kernels
    from repro_torch.kernels import dtype_code, stream_of
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None, help="another checkout's src/repro_torch/csrc")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rglru_variants: no CUDA device is available", file=sys.stderr)
        return 1
    out_dir = vb.ROOT / "build" / "rglru_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: vb.start(out_dir, name, kernels.CSRC, "rglru_scan.cu", subs)
            for name, (subs, _) in VARIANTS.items()}
    jobs[TRACED] = vb.start(out_dir, TRACED, kernels.CSRC, "rglru_scan.cu", flags=("-DREPRO_RGLRU_TRACE",))
    jobs[THREE] = vb.start(out_dir, THREE, kernels.CSRC, vb.ROOT / "tools" / "rglru_three_pass.cu")
    if args.parent_csrc is not None:
        jobs[PARENT] = vb.start(out_dir, PARENT, args.parent_csrc.resolve(), "rglru_scan.cu")
    rec = vb.Record("rglru_variants")
    libs = {}
    out = vb.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    for name, (lib, cdll, log) in vb.finish(jobs).items():
        libs[name] = cdll
        ptx = [ln for ln in vb.ptxas(log) if "Used" in ln or ("spill" in ln and " 0 bytes spill" not in ln)]
        kern = "rglru_scan_kernel" if name == PARENT else ("_kernel" if name == THREE else "rglru_chunk_kernelILb0E")
        rec.emit(variant=name, ptxas=ptx, census=census_of(lib, kern))
        if name in (PARENT, SHIPPED):
            sass = subprocess.run([str(Path(kernels._nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
                                  capture_output=True, text=True, timeout=300).stdout
            (out / f"rglru_sass_{'parent' if name == PARENT else 'shipped'}.txt").write_text(sass)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    B, T, W = 1, 4096, 2560
    a32 = torch.rand((B, T, W), generator=g, device=dev) * 0.499 + 0.5
    b32 = torch.randn((B, T, W), generator=g, device=dev) * 0.1
    h0 = torch.randn((B, W), generator=g, device=dev)
    inputs = {"f32": (a32, b32), "bf16": (a32.to(torch.bfloat16), b32.to(torch.bfloat16))}
    plain = {k: rg_ref.linear_scan(a, b, h0) for k, (a, b) in inputs.items()}

    def caller(name, a, b):
        vec = rg_ops.LANE_CHANNELS
        res = torch.empty((B, T, W), dtype=torch.float32, device=dev)
        scratch = None
        if name == PARENT:
            fn = getattr(libs[name], "repro_rglru_scan")
            fn.argtypes, fn.restype = PARENT_ARGS, ctypes.c_int
            argv = (dtype_code(a.dtype), a.data_ptr(), b.data_ptr(), h0.data_ptr(), res.data_ptr(), B, T, W)
        else:  # the shipped C entry, or the three launches' with the same arguments
            chunk = VARIANTS.get(name, (None, rg_ops.CHUNK))[1]
            nc, nt = -(-T // chunk), -(-W // (32 * vec))
            words = B * nc * 3 * W if name == THREE else (1 + B * nc * nt + 3) // 4 * 4 + B * nc * 2 * W
            scratch = torch.empty((words,), dtype=torch.int32, device=dev)
            fn = getattr(libs[name], "repro_rglru_scan_three_pass" if name == THREE else "repro_rglru_scan")
            fn.argtypes, fn.restype = ARGS, ctypes.c_int
            argv = (dtype_code(a.dtype), a.data_ptr(), b.data_ptr(), h0.data_ptr(), res.data_ptr(),
                    scratch.data_ptr(), B, T, W, vec)

        def run():
            rc = fn(*argv, stream_of(a))
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed with error {rc}")
            return res

        run.scratch = scratch  # alive as long as the launches that use it

        return run

    shipped = {k: caller(SHIPPED, a, b)().clone() for k, (a, b) in inputs.items()}
    names = list(jobs)
    for rnd, order in vb.rounds(names):
        for name in order:
            for kind, (a, b) in inputs.items():
                run = caller(name, a, b)
                got = run().clone()
                torch.cuda.synchronize()
                rec.emit(round=rnd, variant=name, gates=kind, device_ms=device_ms(run, "", n=20),
                         ms=time_ms(run, iters=20), bitwise_shipped=torch.equal(got, shipped[kind]),
                         max_abs_err_plain=float((got - plain[kind]).abs().max()))
    # one traced launch a gate type: each block's phases in ns (%globaltimer)
    copy = libs[TRACED].repro_rglru_trace_copy
    copy.argtypes, copy.restype = [ctypes.c_void_p, ctypes.c_ulong], ctypes.c_int
    for kind, (a, b) in inputs.items():
        run = caller(TRACED, a, b)
        run()
        torch.cuda.synchronize()
        nc = -(-T // rg_ops.CHUNK)
        nblocks = nc * -(-W // (32 * rg_ops.LANE_CHANNELS))
        raw = torch.zeros((nblocks, 8), dtype=torch.int64)
        if copy(raw.data_ptr(), raw.numel() * 8) != 0:
            raise RuntimeError("rglru_trace_copy failed")
        t = raw[:, 1:].double()
        t = t - t[:, 0].min()
        steps = ("ticket", "load_and_segments", "wait_flags", "fold", "barrier", "walk")
        phase = {n: t[:, i + 1] - t[:, i] for i, n in enumerate(steps)}
        life = t[:, 6] - t[:, 0]
        chunk = torch.arange(nblocks) // (nblocks // nc)
        cuts = (0, nc // 3, 2 * nc // 3, nc)
        thirds = {f"chunks {lo}-{hi - 1}": (chunk >= lo) & (chunk < hi) for lo, hi in zip(cuts, cuts[1:])}
        rec.emit(trace=kind, blocks=nblocks, span_ns=float(t[:, 6].max()),
                 mean_blocks_resident=float(life.sum() / t[:, 6].max()),
                 mean_ns={n: float(v.mean()) for n, v in phase.items()} | {"life": float(life.mean())},
                 mean_ns_by_chunk={k: {n: float(v[m].mean()) for n, v in phase.items()} for k, m in thirds.items()},
                 sms_used=int(raw[:, 0].unique().numel()))
        (out / f"rglru_trace_{kind}.json").write_text(json.dumps(raw.tolist()))
    rec.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
