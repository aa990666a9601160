"""Hand-written Hopper kernels of the port, built at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``build/repro_torch/<name>-<hash>.so``,
the hash covering the sources and flags, so an unchanged source is never
rebuilt) and bound with ``ctypes``.  :func:`build_all` starts one ``nvcc``
per source, all together.  Nothing is compiled or loaded at import time:
hosts without ``nvcc`` import these modules and run the plain versions.

  flash_decode     flash-decode steered by lengths over the contiguous KV
                   cache, by block tables over the paged pool, and by
                   positions over a rolling window buffer (one source,
                   three row-address policies, each over a full-precision
                   or an int8 cache with per-row scales)
  flash_attention  blocked causal / local-window GQA prefill attention (and,
                   for training, its instantiations that also write each
                   row's log-sum-exp)
  flash_attention_bwd  kernel 7's backward: dQ, dK, dV from the forward's
                   output and log-sum-exps (training)
  moe_decode       plan-steered expert SwiGLU for tiny T (decode), over
                   full-precision or int8 expert stacks
  moe_fused        prefill MoE: gather + gate/up + SwiGLU, down + a
                   fixed-order combine
  grouped_gemm     y[e] = x[e] @ w[e] over expert slots (the a2a down projection)
  moe_dispatch     plan-steered dispatch into expert slots and weighted combine
  moe_fused_bwd    kernels 3 and 4's backward: dx and the three stacks'
                   gradients, and the plan's slot weights' (training)
  rglru_scan       the RG-LRU's diagonal linear recurrence (prefill), and
                   its reversed instantiation, the backward (training)
  ssd_scan         Mamba-2's chunked state-space-dual scan (prefill), and
                   its backward (training)

Every wrapper in ``kernels/<name>/ops.py`` takes its plain version (the
sibling ``ref.py``) only for CPU tensors; on ``cuda`` it launches its kernel
or raises, and adds one to its ``launches`` counter per launch; a wrapper
with an int8 branch also has an ``int8_launches`` counter, for that
branch's launches (:func:`count_launch`).  A CUDA graph of a launch
(:mod:`repro_torch.launch.steps`) records the counts its capture took and
adds them at each replay (:func:`recorded_launches`).
"""
from __future__ import annotations

import contextlib
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
SOURCES = ("flash_decode", "flash_attention", "moe_decode", "moe_fused", "rglru_scan", "ssd_scan",
           "grouped_gemm", "moe_dispatch", "flash_attention_bwd", "moe_fused_bwd")
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


def stream_of(t) -> int:
    """The raw handle of the current stream on ``t``'s card, for a
    ``c_void_p`` argument.  ``torch.cuda.current_stream()`` builds a Stream
    object on every call, several microseconds of host time a launch
    (``chip_smoke.py``, row ``flash_decode``'s ``host_parts_ms``); the raw
    handle costs none of that."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def dtype_code(dtype) -> int:
    """0 = float32, 1 = bfloat16: the two types every kernel is built for;
    2 = int8, the stored operand (K/V, expert stacks) of the int8 branches."""
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    if dtype == torch.int8:
        return 2
    raise TypeError(f"kernels take float32, bfloat16 or (stored operands) int8, got {dtype}")


def count_launch(wrapper, int8: bool = False) -> None:
    """Add one to ``wrapper``'s launch counter, or with ``int8`` to its
    int8 branch's."""
    if int8:
        wrapper.int8_launches += 1
    else:
        wrapper.launches += 1


def reset_launch_counts() -> None:
    """Set every wrapper's launch counters to 0."""
    for w in kernel_wrappers().values():
        w.launches = 0
        if hasattr(w, "int8_launches"):
            w.int8_launches = 0


def launch_counts() -> Dict[str, int]:
    """name -> launches since the last reset, for every kernel of the
    serving and training paths and, as ``<name>_int8``, every int8 branch."""
    counts = {}
    for name, w in kernel_wrappers().items():
        counts[name] = w.launches
        if hasattr(w, "int8_launches"):
            counts[name + "_int8"] = w.int8_launches
    return counts


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (named as :func:`launch_counts` names them) to the
    wrappers' counters: a CUDA graph's replay launches the kernels its
    capture recorded without running a wrapper that would count them."""
    wrappers = kernel_wrappers()
    for name, n in counts.items():
        if name in wrappers:
            wrappers[name].launches += n
        else:
            wrappers[name[:-len("_int8")]].int8_launches += n


@contextlib.contextmanager
def recorded_launches():
    """Take the launches counted inside the block back out of the counters
    and yield them, a dict filled on exit (name -> count, the nonzero
    ones): a capture runs the wrappers, which count, but launches
    nothing until each replay adds the recorded counts
    (:func:`add_launch_counts`)."""
    before = launch_counts()
    taken: Dict[str, int] = {}
    try:
        yield taken
    finally:
        after = launch_counts()
        taken.update({n: after[n] - before[n] for n in after if after[n] != before[n]})
        add_launch_counts({n: -c for n, c in taken.items()})


def kernel_wrappers() -> dict:
    """name -> wrapper function for every kernel of the serving and
    training paths."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_kernel,
        flash_attention_kernel,
        flash_decode_kernel,
        flash_decode_paged_kernel,
        flash_decode_window_kernel,
    )
    from repro_torch.kernels.grouped_gemm.ops import grouped_gemm, grouped_gemm_bwd
    from repro_torch.kernels.moe_decode.ops import decode_moe_kernel
    from repro_torch.kernels.moe_dispatch.ops import combine, combine_bwd, dispatch, dispatch_bwd
    from repro_torch.kernels.moe_fused.ops import down_combine, down_combine_bwd, gather_swiglu, gather_swiglu_bwd
    from repro_torch.kernels.rglru_scan.ops import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_bwd

    return {
        "flash_decode": flash_decode_kernel,
        "flash_decode_paged": flash_decode_paged_kernel,
        "decode_moe": decode_moe_kernel,
        "gather_swiglu": gather_swiglu,
        "down_combine": down_combine,
        "flash_decode_window": flash_decode_window_kernel,
        "flash_attention": flash_attention_kernel,
        "rglru_scan": rglru_scan,
        "ssd_scan": ssd_scan,
        "grouped_gemm": grouped_gemm,
        "moe_dispatch": dispatch,
        "moe_combine": combine,
        "flash_attention_bwd": flash_attention_bwd_kernel,
        "gather_swiglu_bwd": gather_swiglu_bwd,
        "down_combine_bwd": down_combine_bwd,
        "rglru_scan_bwd": rglru_scan_bwd,
        "ssd_scan_bwd": ssd_scan_bwd,
        "grouped_gemm_bwd": grouped_gemm_bwd,
        "moe_combine_bwd": combine_bwd,
        "moe_dispatch_bwd": dispatch_bwd,
    }
