"""What the tools that time a kernel's variants on the card share.

A variant is a copy of ``src/repro_torch/csrc`` (this tree's, or another
checkout's) with some lines of one source replaced, built with the
package's flags into a directory of its own under ``build/``.  This module
starts those builds all at once, waits for them, reads each one's ``ptxas``
report, counts misses of row 7's bf16 gate, orders rounds, and keeps the
JSON lines a tool prints.  Imported by ``tools/*_variants.py``; only
:func:`start` needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def start(out_dir: Path, tag: str, csrc_from: Path, source: str | Path, subs: dict | None = None, *,
          every: bool = False, flags: tuple = ()) -> tuple[Path, subprocess.Popen]:
    """Copy ``csrc_from`` to a directory of ``out_dir`` named after ``tag``,
    replace each key of ``subs`` in ``source`` by its value (a key must
    occur once, or with ``every`` at least once and each occurrence is
    replaced), and start ``nvcc`` on ``source`` with the package's flags.
    ``source`` is a file name in ``csrc_from``, or a path elsewhere, copied
    in beside the sources it includes.  Returns (library, process)."""
    from repro_torch import kernels

    csrc = out_dir / "".join(c if c.isalnum() else "_" for c in tag)
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(csrc_from, csrc)
    source = Path(source)
    if source.parent != Path("."):
        shutil.copy(source, csrc / source.name)
    path = csrc / source.name
    src = path.read_text()
    for old, new in (subs or {}).items():
        n = src.count(old)
        assert n >= 1 if every else n == 1, f"{tag}: {old!r} is in {source.name} {n} times: update the tool"
        src = src.replace(old, new)
    path.write_text(src)
    lib = csrc / "lib.so"
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", str(csrc), "-o", str(lib),
                             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib, proc


def finish(jobs: dict) -> dict:
    """Wait for each build of ``jobs`` (tag -> (library, process)) and load
    it: tag -> (library path, ctypes library, nvcc's log).  Raises on the
    first build that failed."""
    out = {}
    for tag, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc failed\n{log[-3000:]}")
        out[tag] = (lib, ctypes.CDLL(str(lib)), log)
    return out


def ptxas(log: str, *names: str) -> list:
    """``ptxas``'s lines in ``log`` for each function whose mangled name
    holds one of ``names`` (every function without ``names``): its name,
    then its registers, spills and ``setmaxnreg`` / ``wgmma`` notes."""
    lines, take = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            take = not names or any(k in ln for k in names)
            if take:
                lines.append(ln.split("'")[1])
        elif take and any(w in ln for w in ("Used", "spill", "setmaxnreg", "wgmma")):
            lines.append(ln.strip())
    return lines


def misses(got, want) -> int:
    """Elements of ``got`` outside row 7's bf16 gate around ``want``:
    2^-7 |want| + 1e-3 of want's rms."""
    g, w = got.float(), want.float()
    lim = 2.0 ** -7 * w.abs() + 1e-3 * float(w.pow(2).mean().sqrt())
    return int(((g - w).abs() > lim).sum())


def rounds(names: list) -> list:
    """Two rounds, the second in the opposite order: [(0, names), (1, names reversed)]."""
    return [(0, list(names)), (1, list(names)[::-1])]


class Record:
    """The JSON lines a tool prints, all also written to
    ``chiprun_out/<name>.json`` by :meth:`save`."""

    def __init__(self, name: str):
        self.name, self.lines = name, []

    def emit(self, **fields) -> dict:
        self.lines.append(fields)
        print(json.dumps(fields, default=str), flush=True)
        return fields

    def save(self) -> Path:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        path = out / f"{self.name}.json"
        path.write_text(json.dumps(self.lines, indent=1, default=str))
        return path
