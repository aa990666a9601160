"""Hand-written Hopper kernels of the port, built at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``build/repro_torch/<name>-<hash>.so``,
the hash covering the sources and flags, so an unchanged source is never
rebuilt) and bound with ``ctypes``.  :func:`build_all` starts one ``nvcc``
per source, all together.  Nothing is compiled or loaded at import time:
hosts without ``nvcc`` import these modules and run the plain versions.

  flash_attention  vector-steered flash-decode over the contiguous KV cache
  moe_decode       plan-steered expert SwiGLU for tiny T (decode)
  moe_fused        prefill MoE: gather + gate/up + SwiGLU, down + combine

Every wrapper in ``kernels/<name>/ops.py`` takes its plain version (the
sibling ``ref.py``) only for CPU tensors; on ``cuda`` it launches its kernel
or raises, and adds one to its ``launches`` counter per launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

REPO = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = REPO / "build" / "repro_torch"
SOURCES = ("flash_decode", "moe_decode", "moe_fused")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel; returns the wall seconds.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``<name>-<hash>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, out, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (exit {rc}, see {out.with_suffix('.log')})")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of library ``name`` with its C signature declared (every
    pointer and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_launch(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_code(dtype) -> int:
    """0 = float32, 1 = bfloat16: the two types every kernel is built for."""
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def reset_launch_counts() -> None:
    """Set every wrapper's launch counter to 0."""
    for w in kernel_wrappers().values():
        w.launches = 0


def kernel_wrappers() -> dict:
    """name -> wrapper function for every kernel of the main path."""
    from repro_torch.kernels.flash_attention.ops import flash_decode_kernel
    from repro_torch.kernels.moe_decode.ops import decode_moe_kernel
    from repro_torch.kernels.moe_fused.ops import down_combine, gather_swiglu

    return {
        "flash_decode": flash_decode_kernel,
        "decode_moe": decode_moe_kernel,
        "gather_swiglu": gather_swiglu,
        "down_combine": down_combine,
    }
