#!/usr/bin/env python3
"""Two checkouts' training cell of ``chip_smoke.py`` on one card, in
turns: A, B, B, A.  ``--cell`` names the cell: ``train_full_width``
(StarCoder2-3B at published widths cut to 20 layers, AdamW, 4 x 2,048
tokens a step), ``train_moe_full_width`` (Qwen3-MoE-235B-A22B cut to 2
layers, Adafactor, 2 x 2,048), ``train_rec_full_width``
(RecurrentGemma-2B uncut, AdamW, 2 x 2,048), ``train_ssm_full_width``
(Mamba-2-2.7B uncut, AdamW, 2 x 2,048) or ``train_mesh`` (the sharded step
on a one-rank NCCL mesh, after ``train_moe_full_width`` in the same process,
whose first loss and grad norm it is held to; its tp cell is reported).

    python3 tools/train_ab.py --cell train_rec_full_width --a build/parent --b . [--tags parent,change]

Each run is a process of its own started from its checkout's root (its
own kernel builds under that root's ``build/``), never two at once.  Prints
one JSON line a run (ms a step, tokens/s, share of the bf16 peak, peak
memory, idle share and device ms by kernel of the profiled step, launches
a step) and a summary of the ms a step; all go to
``chiprun_out/<cell>_ab.json``.  Exits non-zero if any run did.  Needs the
card; a checkout is any directory holding the repository's files (``git
archive`` of a commit unpacked under ``build/``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN = """
import json, sys
sys.path.insert(0, "src")
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
if sys.argv[1] == "train_mesh":  # its tp cell, beside the fused pair's step of the same process
    out = cs.train_mesh(dev, cs.train_moe_full_width(dev))["tp"]
else:
    out = getattr(cs, sys.argv[1])(dev)
print("RESULT " + json.dumps(out, default=str), flush=True)
"""
KEEP = ("ms_per_step", "ms_per_step_range", "step_ms_each", "tokens_per_s", "model_flops_share_of_bf16_peak",
        "peak_memory_allocated", "kernel_launches", "profiled_step", "ms_per_step_train_moe_full_width",
        "first_step_vs_train_moe_full_width")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", type=Path, required=True, help="root of checkout A (run first and last)")
    ap.add_argument("--b", type=Path, required=True, help="root of checkout B (run second and third)")
    ap.add_argument("--tags", default="a,b", help="names of A and B in the output")
    ap.add_argument("--cell", required=True, choices=("train_full_width", "train_moe_full_width",
                                                      "train_rec_full_width", "train_ssm_full_width", "train_mesh"),
                    help="chip_smoke.py's training cell")
    args = ap.parse_args()
    tags = dict(zip(("a", "b"), args.tags.split(",")))
    runs, rc = [], 0
    for n, which in enumerate(("a", "b", "b", "a"), start=1):
        tree = getattr(args, which).resolve()
        proc = subprocess.run([sys.executable, "-c", RUN, args.cell], cwd=tree, capture_output=True, text=True,
                              timeout=1200)
        line = next((ln[len("RESULT "):] for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
        rec = {k: v for k, v in json.loads(line).items() if k in KEEP} if line else {}
        rec.update(run=n, tag=tags[which], cell=args.cell, rc=proc.returncode)
        if proc.returncode or not line:
            rc = 1
            rec["stderr_tail"] = proc.stderr[-3000:]
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {r["tag"] + f" (run {r['run']})": r.get("ms_per_step") for r in runs}
    print(json.dumps({"ms_per_step": summary}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{args.cell}_ab.json").write_text(json.dumps(runs, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
