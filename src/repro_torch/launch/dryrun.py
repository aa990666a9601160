"""Host-only dry run: a cell's per-rank memory, FLOPs, collectives and
roofline on the production mesh, counted from the config and the shapes
(the role of ``repro/launch/dryrun.py``'s ``run_cell``).

The reference lowers and compiles each (arch, cell) on 512 forced host
devices and reads XLA's analyses.  Here nothing runs and nothing is
allocated: the mesh is rank 0's view of the production shape
(:func:`repro_torch.launch.analysis.shape_mesh`; the placement rules read
only its shape and coordinates), the leaves are meta tensors, and every
count is exact in depth, so no two-twin extrapolation is needed
(``twin_extrapolation`` is null).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --cell train_4k --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

# the reference's production meshes (launch/mesh.make_production_mesh)
PRODUCTION_MESH = {False: {"data": 16, "model": 16}, True: {"pod": 2, "data": 16, "model": 16}}
SKIP_REASON = "long_500k needs sub-quadratic sequence mixing (full attention arch)"


def argument_bytes(cfg, cell, mesh, strategy: str = "tp") -> int:
    """One rank's bytes of a step's arguments under the port's placement,
    from meta tensors: train, the rank's shards of the f32 master params
    (``parallel.sharding.param_pspecs``) and of the optimizer state the
    optimizer makes for them (``opt_state_pspecs``' placement); prefill and
    decode, the serving params (the rank's expert slice, every other leaf
    whole: ``serve_pspecs``) and the decode cache of the rank's slots (the
    slots split over the data axes that divide them, ``batch_spec``; the
    port's serving keeps heads whole, and a paged pool has no batch dim,
    as ``cache_spec_for`` places it)."""
    from repro_torch.launch.analysis import _serve_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import make_optimizer, scan_of
    from repro_torch.parallel.collectives import tree_bytes
    from repro_torch.parallel.sharding import expert_slice, param_pspecs, shard_tree

    if cell.step == "train":
        shapes = T.init_params(cfg, None, "meta", train=True)
        shards = shard_tree(shapes, param_pspecs(shapes, mesh, strategy=strategy), mesh)
        opt = make_optimizer(cfg.optimizer, 1e-3, scan=scan_of(cfg)).init(shards)
        return tree_bytes(shards) + tree_bytes(opt)
    params = T.init_params(cfg, None, "meta", expert_slice(cfg, mesh) if cfg.is_moe else None)
    slots, _ = _serve_batch(cell, mesh)
    cache = T.init_cache(cfg, slots, cell.seq_len, "meta", pool_batch=cell.global_batch)
    return tree_bytes(params) + tree_bytes(cache)


def run_cell(arch: str, cell_name: str, multi_pod: bool, out_dir: Path, strategy: str = "tp",
             capacity_factor: float = None) -> dict:
    """The reference's ``run_cell`` record, counted (module docstring):
    ``cost`` holds :func:`~repro_torch.launch.analysis.step_flops` per
    device and the analytic HBM bytes, ``memory`` :func:`argument_bytes`,
    ``collectives`` :func:`~repro_torch.launch.analysis.collective_bytes`;
    ``lower_s`` the seconds the counts took, ``compile_s`` and
    ``hlo_bytes`` 0 (nothing is compiled).  Written to ``out_dir`` under
    the reference's tag."""
    from repro_torch.configs import SHAPE_CELLS, cells_for, get_config
    from repro_torch.launch.analysis import (
        analytic_memory_bytes,
        collective_bytes,
        roofline,
        shape_mesh,
        step_flops,
    )

    cfg = get_config(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    cell = SHAPE_CELLS[cell_name]
    if cell not in cells_for(cfg):
        return {"arch": arch, "cell": cell_name, "multi_pod": multi_pod, "status": "skipped", "reason": SKIP_REASON}

    shape = PRODUCTION_MESH[bool(multi_pod)]
    n_dev = 1
    for v in shape.values():
        n_dev *= v
    rec = {"arch": arch, "cell": cell_name, "multi_pod": multi_pod, "strategy": strategy, "mesh": dict(shape),
           "step": cell.step, "status": "error"}
    t0 = time.time()
    try:
        mesh = shape_mesh(shape)
        n_data = n_dev // shape["model"]
        cost = {"flops": step_flops(cfg, cell) / n_dev,
                "bytes accessed": analytic_memory_bytes(cfg, cell, shape["model"], n_data)["total_bytes"]}
        mem = {"argument_size_in_bytes": float(argument_bytes(cfg, cell, mesh, strategy))}
        coll = collective_bytes(cfg, cell, shape, strategy)
        rec.update(
            status="ok",
            lower_s=round(time.time() - t0, 1),
            compile_s=0.0,
            n_devices=n_dev,
            cost=cost,
            memory=mem,
            collectives={
                "wire_bytes": coll["wire_bytes"],
                "control_wire_bytes": coll["control_wire_bytes"],
                "control_share": coll["control_share"],
                "per_op": {k: v for k, v in coll["per_op"].items() if v["count"]},
            },
            roofline=roofline(cost, coll, cfg, cell, n_dev, mesh_shape=rec["mesh"]),
            twin_extrapolation=None,
            hlo_bytes=0,
        )
    except Exception as e:  # a dry-run failure is a bug in the system
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{cell_name}__{'pod2' if multi_pod else 'pod1'}"
    if strategy != "tp":
        tag += f"__{strategy}"
    if capacity_factor is not None:
        tag += f"__cf{capacity_factor}"
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=2, default=float))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", help="architecture id (see --list)")
    ap.add_argument("--cell", help="shape cell (train_4k|prefill_32k|decode_32k|long_500k)")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh (512 ranks)")
    ap.add_argument("--all", action="store_true", help="run every (arch, cell) sequentially")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--strategy", default="tp", choices=("tp", "fsdp"))
    ap.add_argument("--cf", type=float, default=None, help="MoE capacity_factor override")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    from repro_torch.configs import cells_for, get_config, list_archs

    if args.list:
        for a in list_archs():
            print(a, "->", ",".join(c.name for c in cells_for(get_config(a))))
        return 0

    out = Path(args.out)
    if args.all:
        ok = True
        for a in list_archs():
            for c in cells_for(get_config(a)):
                for mp in (False, True):
                    rec = run_cell(a, c.name, mp, out, strategy=args.strategy, capacity_factor=args.cf)
                    print(f"{a:26s} {c.name:12s} {'pod2' if mp else 'pod1':5s} {rec['status']:8s} "
                          f"{rec.get('error', '')}")
                    ok &= rec["status"] in ("ok", "skipped")
        return 0 if ok else 1

    if not args.arch or not args.cell:
        ap.error("--arch and --cell are needed without --all or --list")
    rec = run_cell(args.arch, args.cell, args.multi_pod, out, strategy=args.strategy, capacity_factor=args.cf)
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}, indent=2, default=float))
    if rec["status"] == "error":
        print(rec.get("traceback", ""), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
