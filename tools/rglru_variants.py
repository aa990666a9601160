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
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

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


def build(i: int, name: str, csrc_from: Path, subs: dict, source: Path, out_dir: Path, flags=()):
    from repro_torch import kernels

    csrc = out_dir / f"v{i}"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(csrc_from, csrc)
    src = (csrc / "rglru_scan.cu").read_text()
    for old, new in subs.items():
        assert src.count(old) == 1, f"{old!r} moved: update tools/rglru_variants.py"
        src = src.replace(old, new)
    (csrc / "rglru_scan.cu").write_text(src)
    if source.parent != csrc_from:
        shutil.copy(source, csrc / source.name)
    lib = csrc / "lib.so"
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", str(csrc), "-o", str(lib),
                             str(csrc / source.name)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc


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
    out_dir = ROOT / "build" / "rglru_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped_src = kernels.CSRC / "rglru_scan.cu"
    jobs = {name: build(i, name, kernels.CSRC, subs, shipped_src, out_dir)
            for i, (name, (subs, _)) in enumerate(VARIANTS.items())}
    jobs[TRACED] = build(len(jobs), TRACED, kernels.CSRC, {}, shipped_src, out_dir, ("-DREPRO_RGLRU_TRACE",))
    jobs[THREE] = build(len(jobs), THREE, kernels.CSRC, {}, ROOT / "tools" / "rglru_three_pass.cu", out_dir)
    if args.parent_csrc is not None:
        jobs[PARENT] = build(len(jobs), PARENT, args.parent_csrc.resolve(), {},
                             args.parent_csrc.resolve() / "rglru_scan.cu", out_dir)
    libs, lines = {}, []
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(lib))
        ptx = [ln.strip() for ln in log.splitlines() if "Used" in ln or ("spill" in ln and " 0 bytes spill" not in ln)]
        kern = "rglru_scan_kernel" if name == PARENT else ("_kernel" if name == THREE else "rglru_chunk_kernelILb0E")
        lines.append({"variant": name, "ptxas": ptx, "census": census_of(lib, kern)})
        print(json.dumps(lines[-1]), flush=True)
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
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            for kind, (a, b) in inputs.items():
                run = caller(name, a, b)
                got = run().clone()
                torch.cuda.synchronize()
                lines.append({"round": rnd, "variant": name, "gates": kind, "device_ms": device_ms(run, "", n=20),
                              "ms": time_ms(run, iters=20), "bitwise_shipped": torch.equal(got, shipped[kind]),
                              "max_abs_err_plain": float((got - plain[kind]).abs().max())})
                print(json.dumps(lines[-1]), flush=True)
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
        lines.append({
            "trace": kind, "blocks": nblocks, "span_ns": float(t[:, 6].max()),
            "mean_blocks_resident": float(life.sum() / t[:, 6].max()),
            "mean_ns": {n: float(v.mean()) for n, v in phase.items()} | {"life": float(life.mean())},
            "mean_ns_by_chunk": {k: {n: float(v[m].mean()) for n, v in phase.items()} for k, m in thirds.items()},
            "sms_used": int(raw[:, 0].unique().numel())})
        print(json.dumps(lines[-1]), flush=True)
        (out / f"rglru_trace_{kind}.json").write_text(json.dumps(raw.tolist()))
    (out / "rglru_variants.json").write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
