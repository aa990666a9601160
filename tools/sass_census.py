#!/usr/bin/env python3
"""Static SASS census of a port kernel built from any checkout's sources.

    PYTHONPATH=src python3 tools/sass_census.py --csrc OTHER/src/repro_torch/csrc moe_decode gate_up_kernel

Builds ``<csrc>/<name>.cu`` with the package's ``nvcc`` flags into
``build/sass_census/`` and prints, as one JSON object, the instruction counts
of each kernel whose mangled name holds one of the given names
(``chip_smoke.census_of``: every instruction, and the opcodes of
``chip_smoke.CENSUS_OPS``).  Needs ``nvcc`` and ``cuobjdump`` (the CUDA
toolkit), not a card: used to read a parent checkout's build beside the
census ``chip_smoke.py`` records for this tree's.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    from chip_smoke import census_of
    from repro_torch import kernels

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=kernels.CSRC, help="the csrc directory to build from")
    ap.add_argument("source", help="csrc/<source>.cu")
    ap.add_argument("names", nargs="+", help="substrings of the kernels' mangled names")
    args = ap.parse_args()
    out_dir = ROOT / "build" / "sass_census"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{args.source}-{hashlib.sha256(str(args.csrc.resolve()).encode()).hexdigest()[:12]}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(args.csrc), "-o", str(lib),
                    str(args.csrc / f"{args.source}.cu")], check=True, capture_output=True)
    print(json.dumps({"csrc": str(args.csrc), "source": args.source, "census": census_of(lib, *args.names)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
