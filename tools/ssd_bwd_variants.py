#!/usr/bin/env python3
"""Kernel 11's backward (``11_bwd``, ``csrc/ssd_scan.cu`` namespaces
``bwd_tc`` and ``bwd``) on the card: its tensor-core build beside its
CUDA-core build and other checkouts' builds, at Mamba-2-2.7B's training
shape.

    python3 tools/ssd_bwd_variants.py [--csrc TAG=DIR ...] [--rounds 2]

Builds: ``shipped`` (this tree, through the wrapper: bf16 at N 128, P 64
takes ``repro_ssd_scan_bwd_tc``), ``cuda cores`` (the same library with
``ssd_scan_bwd_path`` forced to the CUDA-core entry) and each ``--csrc
TAG=DIR``, another checkout's ``ssd_scan.cu`` built with the package's
flags under ``build/ssd_bwd_variants/`` (through its tensor-core entry
where it has one, over a scratch as large as either of this tree's builds
asks for: another checkout's layout may differ).  Case:
``REC_TRAIN_BATCH`` x ``TRAIN_SEQ`` of ``chip_smoke.py`` at 80 heads of 64,
state 128, bf16 x, B and C as views of one projection, dy f32, from a
seed.  Each build: every gradient against
the plain version (``ssd_chunked_bwd`` at chunk 256) by ``chip_smoke``'s
gates (1e-4 of the scale on the f32 outputs, ``check_bf16`` on the bf16
ones), bitwise on a repeat; CUDA-event ms in rounds (the order reversed
every other round), device ms and device ms by launch (under whichever
build's launch names the library answers to).  Registers and spills of
both builds' kernels.  One JSON line a measurement; all also go to
``chiprun_out/ssd_bwd_variants.json``.  Needs the card.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import variant_builds as vb

REC = vb.Record("ssd_bwd_variants")
emit = REC.emit


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", default=[], help="TAG=DIR of another checkout's csrc")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit(card=smi, torch=torch.__version__, cuda=torch.version.cuda)

    shipped = kernels.library("ssd_scan")
    emit(build="shipped", ptxas=cs.ptxas("ssd_scan", "3bwd", "6bwd_tc", "chunk_state"))
    libs = {"shipped": (shipped, None), "cuda cores": (shipped, "cuda_cores")}
    out_dir = vb.ROOT / "build" / "ssd_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for spec in args.csrc:
        tag, csrc = spec.split("=", 1)
        jobs[tag] = vb.start(out_dir, tag, Path(csrc).resolve(), "ssd_scan.cu")
    for tag, (_, lib, log) in vb.finish(jobs).items():
        libs[tag] = (lib, None if hasattr(lib, "repro_ssd_scan_bwd_tc") else "cuda_cores")
        emit(build=tag, ptxas=vb.ptxas(log, "3bwd", "6bwd_tc", "chunk_state"))

    scratch_floats = ssd_ops.bwd_scratch_floats

    @contextlib.contextmanager
    def using(tag):
        lib, force = libs[tag]
        ours = kernels._LIBS["ssd_scan"]
        kernels._LIBS["ssd_scan"] = lib
        saved = ssd_ops.ssd_scan_bwd_path
        if force:
            ssd_ops.ssd_scan_bwd_path = lambda *a: force
        if lib is not shipped:
            ssd_ops.bwd_scratch_floats = lambda *a: max(scratch_floats(*a[:5], p) for p in ssd_ops.BWD_CHUNK)
        try:
            yield
        finally:
            kernels._LIBS["ssd_scan"] = ours
            ssd_ops.ssd_scan_bwd_path = saved
            ssd_ops.bwd_scratch_floats = scratch_floats

    cfg = get_config(cs.SSM)
    P, N, Q = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    H = cfg.ssm_expand * cfg.d_model // P
    B, T = cs.REC_TRAIN_BATCH, cs.TRAIN_SEQ
    gen = torch.Generator(device=dev).manual_seed(0)
    proj = (torch.randn((B, T, H * P + 2 * N), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    x, bm, cm = proj[..., :H * P].reshape(B, T, H, P), proj[..., H * P:H * P + N], proj[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=gen, device=dev) - 1.0)
    a = -torch.linspace(1.0, 16.0, H, device=dev)
    dy = torch.randn((B, T, H, P), generator=gen, device=dev)
    want = ssd_ref.ssd_chunked_bwd(x, dt, a, bm, cm, Q, dy)
    nbytes, flops = cs.ssd_bwd_work(B, T, H, P, N, Q, 2)
    emit(case="mamba2_train", shapes=f"x ({B}, {T}, {H}, {P}) bf16 views, B and C ({B}, {T}, {N}), dy f32",
         bytes=nbytes, flops=flops, bound_ms=cs.bound(nbytes, flops)[0], bound_by=cs.bound(nbytes, flops)[1])
    names = ("dx", "ddt", "da", "dB", "dC")

    def kernel():
        return ssd_ops.ssd_scan_bwd(x, dt, a, bm, cm, Q, dy)

    cat = lambda: torch.cat([t.reshape(-1).float() for t in kernel() if t is not None])
    for tag in libs:
        with using(tag):
            got = kernel()
            errs, failed = {}, []
            for n, g, w in zip(names, got, want):
                try:
                    errs[n] = (cs.check_close(n, g, w, 1e-4) if g.dtype == torch.float32 else cs.check_bf16(n, g, w))
                except AssertionError as e:
                    failed.append(str(e))
            emit(case="mamba2_train", build=tag, max_abs_err=errs, failed=failed,
                 bitwise_repeat=bool(torch.equal(cat(), cat())))
            del got
    for r in range(args.rounds):
        order = list(libs) if r % 2 == 0 else list(libs)[::-1]
        ms = {}
        for tag in order:
            with using(tag):
                ms[tag] = cs.time_ms(kernel, iters=3, reps=3)
        emit(case="mamba2_train", round=r, order=order, ms=ms)
    for tag in libs:
        with using(tag):
            # by launch: whichever build's launch names this library's kernels answer to
            by_launch = {s.split("::")[1]: cs.device_ms(kernel, s, n=3)
                         for names in cs.SSD_BWD_LAUNCHES.values() for s in names}
            emit(case="mamba2_train", build=tag, device_ms=cs.device_ms(kernel, "", n=3),
                 device_ms_by_launch={k: v for k, v in by_launch.items() if v is not None})
    REC.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
