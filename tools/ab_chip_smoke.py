#!/usr/bin/env python3
"""Two checkouts' ``chip_smoke.py`` on one card, in turns: A, B, B, A.

    python3 tools/ab_chip_smoke.py --a build/parent --b . [--tags parent,change]

Runs each checkout's ``chip_smoke.py`` from its own root, one after the
other (never two at once), and keeps each run's record and output as
``chiprun_out/ab_<n>_<tag>.json`` / ``.txt``.  Then prints, and writes to
``chiprun_out/ab_summary.json``, one table of what the serving cells
measured in each run: ``prefill_ms_mean`` and ``ms_per_decode_launch`` of
every cell, the device idle share of every profile phase, the ``ms`` (and
``device_ms``) of every kernel row, where the run has the phase
``compiled_launch``, each cell's eager and replayed ms per decode launch
and idle share, and each arch-sweep run's prefill and decode ms.
Exits non-zero if any run did.  Needs the card; a checkout is any
directory holding the repository's files (``git archive`` of a commit
unpacked under ``build/``).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("full_width", "paged_tree", "expert_parallel", "int8_full_width", "int8_paged_tree", "hybrid_window",
         "int8_hybrid_window", "ssm_serve")
PROFILES = ("profile", "profile_paged", "profile_ep", "profile_int8", "profile_hybrid", "profile_ssm")


def summary(record: dict) -> dict:
    cells = {c: {m: record.get(c, {}).get(m) for m in ("prefill_ms_mean", "ms_per_decode_launch")} for c in CELLS}
    idle = {p: record.get(p, {}).get("device_idle_share") for p in PROFILES}
    kern = {n: {m: r.get(m) for m in ("ms", "device_ms")} for n, r in record.get("kernels_vs_plain", {}).items()
            if isinstance(r, dict)}
    graphs = {c: {m: r.get(m) for m in ("eager_ms_per_decode_launch", "replayed_ms_per_decode_launch",
                                       "eager_idle_share", "replayed_idle_share")}
              for c, r in record.get("compiled_launch", {}).items() if isinstance(r, dict)}
    sweep = {a: {m: r.get(m) for m in ("prefill_ms", "decode_ms_per_launch")}
             for a, r in record.get("arch_sweep", {}).items() if isinstance(r, dict)}
    return {"cells": cells, "idle": idle, "kernels": kern, "compiled_launch": graphs, "arch_sweep": sweep}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", type=Path, required=True, help="root of checkout A (run first and last)")
    ap.add_argument("--b", type=Path, required=True, help="root of checkout B (run second and third)")
    ap.add_argument("--tags", default="a,b", help="names of A and B in the output files")
    args = ap.parse_args()
    tags = dict(zip(("a", "b"), args.tags.split(",")))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    runs, rc = [], 0
    for n, which in enumerate(("a", "b", "b", "a"), start=1):
        tree = getattr(args, which).resolve()
        name = f"ab_{n}_{tags[which]}"
        record_path = tree / "chiprun_out" / "chip_smoke.json"
        record_path.unlink(missing_ok=True)
        with open(out / f"{name}.txt", "w") as log:
            run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, stdout=log, stderr=subprocess.STDOUT)
        rc |= run.returncode
        record = json.loads(record_path.read_text()) if record_path.exists() else {}
        if record_path.exists():
            shutil.copy(record_path, out / f"{name}.json")
        runs.append({"run": name, "rc": run.returncode, **summary(record)})
        print(json.dumps({"run": name, "rc": run.returncode}), flush=True)
    (out / "ab_summary.json").write_text(json.dumps(runs, indent=1))
    for r in runs:
        print(json.dumps(r), flush=True)
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
