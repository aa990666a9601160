#!/usr/bin/env python3
"""Kernel 8's backward (``8_bwd``, ``csrc/grouped_gemm.cu`` namespace
``tcb``) on the card: this tree's tensor-core build beside its variants,
other checkouts' builds and two ``torch.bmm`` calls, at the a2a body's
training shape.

    python3 tools/gg_bwd_variants.py [--csrc parent=build/parent/src/repro_torch/csrc ...] [--rounds 4]

Builds, with the package's flags, into ``build/gg_bwd_variants/``:

* ``shipped``: this tree's source, through the wrapper (bf16 with K and N
  multiples of 8 takes ``repro_grouped_gemm_bwd_tc``);
* ``dy streamed``: the shipped source with no dy slice kept on chip
  whatever the host's schedule (every stage of dw brings dy's chunk beside
  x's tile), what residency buys;
* ``dx units of 160``: the shipped source with dx's units one half of
  160 slots (each w tile read by two units at M 320), what the 320-slot
  units buy;
* each ``--csrc TAG=DIR``: another checkout's ``grouped_gemm.cu`` through
  its ``repro_grouped_gemm_bwd_tc`` (where that entry takes no schedule
  and picks dw's itself, the wrapper's call without it).

Case: ``chip_smoke.py``'s ``grouped_gemm_bwd`` row, h (E, C, f) @ w_down
(E, f, d) with dy (E, C, d), bf16 from a seed, E 128, C at Qwen3-MoE's
capacity for ``MOE_TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, f 1,536, d 4,096.
Each build: misses of ``chip_smoke.check_bf16``'s gate on dx and dw against
the plain version, bitwise on a repeat and whether bitwise the shipped
build's; CUDA-event ms in rounds with the
two ``torch.bmm`` calls timed in each (the order reversed every other
round); the profiler's device ms in all and by launch (under whichever
build's launch names the library answers to); registers, spills and a SASS
census of its tensor-core kernels.  One JSON line a measurement; all also
go to ``chiprun_out/gg_bwd_variants.json``.  Needs the card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path

import variant_builds as vb

# each build's tensor-core launches: this tree's, and the single-template build's before it
LAUNCHES = ("dx_wdy_kernel", "dw_xdy_kernel", "dx_tc_kernel", "dw_tc_kernel")
VARIANTS = {
    "dy streamed": {"return resident ? tcb::run_dw<true>(mx, mdy, p, st) : tcb::run_dw<false>(mx, mdy, p, st);":
                    "return tcb::run_dw<false>(mx, mdy, p, st);"},
    "dx units of 160": {"constexpr int DX_HALVES = 2;": "constexpr int DX_HALVES = 1;"},
}
REC = vb.Record("gg_bwd_variants")
emit = REC.emit
ENTRY = "repro_grouped_gemm_bwd_tc"


def takes_schedule(csrc: Path) -> bool:
    """Whether a checkout's tensor-core entry takes dw's schedule from the host."""
    src = (csrc / "grouped_gemm.cu").read_text()
    decl = src[src.index(f'extern "C" int {ENTRY}('):]
    return "int resident" in decl[:decl.index(")")]


class OwnSchedule:
    """A library whose tensor-core entry picks dw's schedule itself: the
    wrapper's call passes on without its schedule argument."""

    def __init__(self, lib):
        self._lib = lib
        fn = getattr(lib, ENTRY)
        fn.argtypes, fn.restype = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
        entry = lambda *a: fn(*a[:9], a[-1])  # noqa: E731  (x .. N, then the stream)
        entry.argtypes = fn.argtypes
        setattr(self, ENTRY, entry)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.control_plane import capacity_for
    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.kernels.grouped_gemm import ref as gg_ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", default=[], help="TAG=DIR of another checkout's csrc")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit(card=smi, torch=torch.__version__, cuda=torch.version.cuda)

    shipped = kernels.library("grouped_gemm")
    emit(build="shipped", ptxas=vb.ptxas(kernels._lib_path("grouped_gemm").with_suffix(".log").read_text(),
                                         *LAUNCHES),
         sass=cs.census_of(kernels._lib_path("grouped_gemm"), *LAUNCHES))
    libs = {"shipped": shipped}
    out_dir = vb.ROOT / "build" / "gg_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {tag: vb.start(out_dir, tag, kernels.CSRC, "grouped_gemm.cu", subs) for tag, subs in VARIANTS.items()}
    own = set()
    for spec in args.csrc:
        tag, csrc = spec.split("=", 1)
        jobs[tag] = vb.start(out_dir, tag, Path(csrc).resolve(), "grouped_gemm.cu")
        if not takes_schedule(Path(csrc)):
            own.add(tag)
    for tag, (path, lib, log) in vb.finish(jobs).items():
        libs[tag] = OwnSchedule(lib) if tag in own else lib
        emit(build=tag, ptxas=vb.ptxas(log, *LAUNCHES), sass=cs.census_of(path, *LAUNCHES))

    @contextlib.contextmanager
    def using(tag):
        ours = kernels._LIBS["grouped_gemm"]
        kernels._LIBS["grouped_gemm"] = libs[tag]
        try:
            yield
        finally:
            kernels._LIBS["grouped_gemm"] = ours

    cfg = get_config(cs.ARCH)
    T, d, f, E, k = cs.MOE_TRAIN_BATCH * cs.TRAIN_SEQ, cfg.d_model, cfg.d_ff_expert, cfg.num_experts, cfg.top_k
    C = capacity_for(T, E, k, cfg.capacity_factor)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    h = (torch.randn((E, C, f), generator=gen, device=dev) * 0.5).to(bf16)
    wd = (torch.randn((E, f, d), generator=gen, device=dev) * f ** -0.5).to(bf16)
    dy = torch.randn((E, C, d), generator=gen, device=dev).to(bf16)
    nbytes = 2 * (E * C * f * 2 + E * f * d * 2) + E * C * d * 2
    flops = 4.0 * E * C * f * d
    bound_ms, bound_by = cs.bound(nbytes, flops)
    emit(case="a2a_train", shapes=f"h ({E}, {C}, {f}) @ w_down ({E}, {f}, {d}), dy ({E}, {C}, {d}) bf16",
         path=gg_ops.grouped_gemm_bwd_path(bf16, f, d, True), schedule=gg_ops.grouped_gemm_bwd_schedule(C),
         bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by)
    want = gg_ref.grouped_gemm_bwd(h, wd, dy)
    kernel = lambda: gg_ops.grouped_gemm_bwd(h, wd, dy)  # noqa: E731
    library = lambda: (torch.bmm(dy, wd.transpose(1, 2)), torch.bmm(h.transpose(1, 2), dy))  # noqa: E731
    cat = lambda: torch.cat([t.reshape(-1) for t in kernel()])  # noqa: E731
    with using("shipped"):
        ours = cat()
    for tag in libs:
        with using(tag):
            got = kernel()
            torch.cuda.synchronize()
            emit(case="a2a_train", build=tag, misses={n: vb.misses(g, w_) for n, g, w_ in zip(("dx", "dw"), got, want)},
                 bitwise_repeat=bool(torch.equal(cat(), cat())), bitwise_shipped=bool(torch.equal(cat(), ours)))
            del got
    del ours
    del want
    torch.cuda.empty_cache()
    names = list(libs) + ["bmm x2"]
    for r in range(args.rounds):
        order = names if r % 2 == 0 else names[::-1]
        ms = {}
        for tag in order:
            if tag == "bmm x2":
                ms[tag] = cs.time_ms(library, iters=3, reps=3)
                continue
            with using(tag):
                ms[tag] = cs.time_ms(kernel, iters=3, reps=3)
        emit(case="a2a_train", round=r, order=order, ms=ms)
    for tag in libs:
        with using(tag):
            by_launch = {n: cs.device_ms(kernel, n, n=3) for n in LAUNCHES}
            emit(case="a2a_train", build=tag, device_ms=cs.device_ms(kernel, "", n=3),
                 device_ms_by_launch={n: v for n, v in by_launch.items() if v is not None})
    emit(case="a2a_train", build="bmm x2", device_ms=cs.device_ms(library, "", n=3))
    REC.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
