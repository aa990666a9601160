#!/usr/bin/env python3
"""Kernels 3 and 4's training backwards (``3_bwd``, ``4_bwd``,
``csrc/moe_fused_bwd.cu``) on the card: the tensor-core builds beside the
CUDA-core builds, variants with lo halves zeroed, other checkouts' builds
and the bf16 composition of PyTorch calls.

    python3 tools/moe_bwd_variants.py [--csrc parent=build/parent/src/repro_torch/csrc ...] [--rounds 2]

Builds, with the package's flags, into ``build/moe_bwd_variants/``:

* ``shipped``: this tree's source, through the wrappers (bf16 with d and f
  multiples of 8 takes the tensor cores);
* ``cuda cores``: the same library with the wrappers' path functions
  forced to the CUDA-core build;
* ``dy lo zeroed``: the shipped source with the lo halves of dy's rows and
  of the weighted slot rows set to 0 (``split8``);
* ``dg/du lo zeroed``: the lo halves of the dg/du pairs set to 0;
* each ``--csrc TAG=DIR``: another checkout's ``moe_fused_bwd.cu``,
  through its tensor-core entries where it has them, else its CUDA-core
  ones.

Cases, bf16 from a seed: ``ragged`` (T 1,000, d 264, f 200, 24 experts
top-4, capacity factor 1.0, a skewed router: empty slots and dropped
assignments) and ``qwen3`` (Qwen3-MoE-235B-A22B's shapes: T 4,096, d
4,096, f 1,536, 128 experts top-8 at the config's capacity).  Each build:
misses of the bf16 gate (``chip_smoke.check_bf16``'s: 2^-7 |plain| + 1e-3
rms) on dh, dWd, dx, dWg and dWu against the plain versions, dslot_w's
error over 1e-4 of its scale, bitwise on a repeat; at ``qwen3`` CUDA-event
ms of each backward in rounds (the order reversed every other round) with
the composition timed in each, and the profiler's device ms by launch.
Registers, spills and a SASS census of the tensor-core kernels.  One JSON
line a measurement; all also go to ``chiprun_out/moe_bwd_variants.json``.
Needs the card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import variant_builds as vb

DY_LO = ("__floats2bfloat162_rn(v[2 * i] - __low2float(hp), v[2 * i + 1] - __high2float(hp))",)
DGU_LO = ("__floats2bfloat162_rn(dg[0] - __low2float(gh), dg[1] - __high2float(gh))",
          "__floats2bfloat162_rn(du[0] - __low2float(uh), du[1] - __high2float(uh))")
VARIANTS = {"dy lo zeroed": DY_LO, "dg/du lo zeroed": DGU_LO}
ZERO = "__floats2bfloat162_rn(0.f, 0.f)"
REC = vb.Record("moe_bwd_variants")
emit = REC.emit


def case_inputs(name: str, gen, dev):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.control_plane import capacity_for, route_topk

    if name == "ragged":
        T, d, f, E, k, cf, std = 1000, 264, 200, 24, 4, 1.0, 0.2
    else:
        cfg = get_config("qwen3-moe-235b-a22b")
        T, d, f, E, k, cf, std = 4096, cfg.d_model, cfg.d_ff_expert, cfg.num_experts, cfg.top_k, \
            cfg.capacity_factor, 0.02
    x32 = torch.randn((T, d), generator=gen, device=dev)
    plan, _ = route_topk(x32, torch.randn((d, E), generator=gen, device=dev) * std, k, capacity_for(T, E, k, cf))
    x = x32.to(torch.bfloat16)
    wg, wu = ((torch.randn((E, d, f), generator=gen, device=dev) * d ** -0.5).to(torch.bfloat16) for _ in range(2))
    wd = (torch.randn((E, f, d), generator=gen, device=dev) * f ** -0.5).to(torch.bfloat16)
    dy = torch.randn((T, d), generator=gen, device=dev)
    return x, plan, wg, wu, wd, dy


def main() -> int:
    import contextlib

    import torch

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.kernels.moe_fused import ops as mf_ops
    from repro_torch.kernels.moe_fused import ref as mf_ref

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

    shipped = kernels.library("moe_fused_bwd")
    path = kernels._lib_path("moe_fused_bwd")
    tc_kernels = [n for names in cs.MOE_BWD_TC_KERNELS.values() for n in names]
    emit(build="shipped", ptxas=cs.ptxas("moe_fused_bwd", *tc_kernels),
         sass={k: {o: v.get(o) for o in ("all", "HGMMA", "STG")} for k, v in cs.census_of(path, *tc_kernels).items()})
    libs = {"shipped": (shipped, None), "cuda cores": (shipped, "cuda_cores")}
    out_dir = vb.ROOT / "build" / "moe_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {tag: vb.start(out_dir, tag, kernels.CSRC, "moe_fused_bwd.cu", dict.fromkeys(lines, ZERO))
            for tag, lines in VARIANTS.items()}
    for spec in args.csrc:
        tag, csrc = spec.split("=", 1)
        jobs[tag] = vb.start(out_dir, tag, Path(csrc).resolve(), "moe_fused_bwd.cu")
    for tag, (_, lib, _) in vb.finish(jobs).items():
        libs[tag] = (lib, None if hasattr(lib, "repro_down_combine_bwd_tc") else "cuda_cores")

    @contextlib.contextmanager
    def using(tag):
        lib, force = libs[tag]
        ours = kernels._LIBS["moe_fused_bwd"]
        kernels._LIBS["moe_fused_bwd"] = lib
        saved = mf_ops.down_combine_bwd_path, mf_ops.gather_swiglu_bwd_path
        if force:
            mf_ops.down_combine_bwd_path = mf_ops.gather_swiglu_bwd_path = lambda *a: force
        try:
            yield
        finally:
            kernels._LIBS["moe_fused_bwd"] = ours
            mf_ops.down_combine_bwd_path, mf_ops.gather_swiglu_bwd_path = saved

    gen = torch.Generator(device=dev).manual_seed(0)
    for case in ("ragged", "qwen3"):
        x, plan, wg, wu, wd, dy = case_inputs(case, gen, dev)
        T, d = x.shape
        E, _, f = wg.shape
        idx, sw, cidx = plan.flat_idx, plan.slot_w, plan.flat_cidx
        C = idx.numel() // E
        h = mf_ops.gather_swiglu(x, idx, wg, wu)
        want4 = mf_ref.down_combine_bwd(dy, h, wd, idx, sw)
        dh = want4[0]  # every build's 3_bwd gets the same dh
        want3 = mf_ref.gather_swiglu_bwd(dh, x, idx, cidx, wg, wu)
        emit(case=case, shapes=f"T {T}, d {d}, f {f}, E {E}, C {C}, top-{cidx.numel() // T}",
             occupied=int((idx < T).sum()), dropped=int((cidx == idx.numel()).sum()),
             path=mf_ops.down_combine_bwd_path(x.dtype, f, d, True))
        down = lambda: mf_ops.down_combine_bwd(dy, h, wd, idx, sw)
        gather = lambda: mf_ops.gather_swiglu_bwd(dh, x, idx, cidx, wg, wu)
        cat = lambda fn: torch.cat([t.reshape(-1).float() for t in fn()])
        for tag in libs:
            with using(tag):
                got4, got3 = down(), gather()
                torch.cuda.synchronize()
                scale = max(1.0, float(want4[2].abs().max()))
                emit(case=case, build=tag,
                     misses={n: vb.misses(g, w) for n, g, w in zip(("dh", "dwd"), got4[:2], want4[:2])}
                     | {n: vb.misses(g, w) for n, g, w in zip(("dx", "dwg", "dwu"), got3, want3)},
                     dslot_w_err_over_1e4_scale=float((got4[2] - want4[2]).abs().max()) / (1e-4 * scale),
                     bitwise_repeat=bool(torch.equal(cat(down), cat(down)) and torch.equal(cat(gather), cat(gather))))
            del got4, got3
        del want4, want3
        torch.cuda.empty_cache()
        if case != "qwen3":
            continue
        comp_down, comp_gather = cs._moe_bwd_composites(x, idx, cidx, wg, wu, wd, sw, h, dy, dh)
        timed = [t for t in libs if t in ("shipped", "cuda cores") or t not in VARIANTS]
        for r in range(args.rounds):
            order = timed if r % 2 == 0 else timed[::-1]
            ms = {}
            for tag in order:
                with using(tag):
                    ms[tag] = {"4_bwd": cs.time_ms(down, iters=2, reps=3), "3_bwd": cs.time_ms(gather, iters=1, reps=3)}
            ms["composition"] = {"4_bwd": cs.time_ms(comp_down, iters=2, reps=3),
                                 "3_bwd": cs.time_ms(comp_gather, iters=2, reps=3)}
            emit(case=case, round=r, order=order, ms=ms)
        for tag in ("shipped", "cuda cores"):
            with using(tag):
                p = "cuda_cores" if tag == "cuda cores" else "tensor_cores"
                emit(case=case, build=tag, device_ms={"4_bwd": cs.device_ms(down, "", n=3),
                                                      "3_bwd": cs.device_ms(gather, "", n=2)},
                     device_ms_by_launch={n: cs.device_ms(lambda: (down(), gather()), n, n=2)
                                          for n in dict.fromkeys(cs.MOE_BWD_LAUNCHES["down_combine_bwd"][p]
                                                                 + cs.MOE_BWD_LAUNCHES["gather_swiglu_bwd"][p])})
        del comp_down, comp_gather
    REC.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
