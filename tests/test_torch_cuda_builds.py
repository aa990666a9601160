"""PyTorch port, on the card: kernels run through a second build of their
sources, its library swapped in under the same wrappers.

* Parity with another checkout: the kernels a change leaves alone give
  bitwise what that checkout's build gives on the same inputs: the
  contiguous and paged flash-decode (f32, bf16, int8 K/V) and kernel 7's
  CUDA-core path (f32 at every head dim, bf16 at 16, 32 and 64).  The C
  entry points ``repro_flash_decode``, ``repro_flash_decode_paged`` and
  ``repro_flash_attention`` must keep their signatures in both trees.
  Skips unless ``REPRO_OTHER_CHECKOUT`` names the other checkout's root:

      REPRO_OTHER_CHECKOUT=/path/to/other PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_builds.py

* Kernel 7's tensor-core path carries P into P.V as hi + lo bf16 halves.
  Built with the lo half zeroed (bf16 P alone), it misses the bf16 gate at
  RecurrentGemma's prefill shape, which the shipped build holds.

Imports no jax.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

OTHER = os.environ.get("REPRO_OTHER_CHECKOUT")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _build(csrc: Path, name: str, out_dir: Path) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with the package's flags into ``out_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{name}.so"
    run = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
                          str(csrc / f"{name}.cu")], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    return ctypes.CDLL(str(out))


@contextlib.contextmanager
def _swapped(name: str, lib: ctypes.CDLL):
    """The wrappers of ``name`` launch from ``lib`` inside the block."""
    ours = kernels.library(name)
    kernels._LIBS[name] = lib
    try:
        yield
    finally:
        kernels._LIBS[name] = ours


# ---------------------------------------------------------------------------
# parity with another checkout
# ---------------------------------------------------------------------------

DECODE_CASES = [f"{kind} {tag}" for tag in ("float32", "bfloat16")
                for kind in ("flash_decode", "flash_decode int8", "flash_decode_paged", "flash_decode_paged int8")]
PREFILL_CASES = [f"flash_attention {tag} hd {hd} window {w}"
                 for tag, hds in (("float32", (16, 32, 64, 128, 256)), ("bfloat16", (16, 32, 64)))
                 for hd in hds for w in (0, 45)]


def _run(case: str, dev) -> torch.Tensor:
    """One wrapper launch of ``case`` on inputs made from a seed."""
    from repro_torch.core.quant import quantize_int8

    g = torch.Generator(device=dev).manual_seed(len(case))
    words = case.split()
    dt = getattr(torch, words[1] if words[1] != "int8" else words[2])
    if words[0] == "flash_attention":
        hd, window = int(words[3]), int(words[5])
        Sq, nq, nkv = (1200, 10, 1) if hd == 256 else (197, 16, 4)
        q = torch.randn((1, Sq, nq, hd), generator=g, device=dev).to(dt)
        k, v = (torch.randn((1, Sq, nkv, hd), generator=g, device=dev).to(dt) for _ in range(2))
        return fa_ops.flash_attention_kernel(q, k, v, causal=True, window=window)
    B, T, nq, nkv, hd, S, ps = 3, 4, 16, 4, 128, 208, 16
    base = torch.tensor([0, 77, S - T - 3], dtype=torch.int32, device=dev)
    lengths = (base[:, None] + torch.arange(1, T + 1, dtype=torch.int32, device=dev)).reshape(-1).contiguous()
    anc = torch.tensor([1, 3, 5, 11], dtype=torch.int32, device=dev)
    q = torch.randn((B, T, nq, hd), generator=g, device=dev).to(dt)
    k, v = (torch.randn((B, S, nkv, hd), generator=g, device=dev) for _ in range(2))
    scales = None
    if "int8" in words:
        (k, ks), (v, vs) = (quantize_int8(c, axis=(-2, -1)) for c in (k, v))
        scales = torch.stack([ks[..., 0, 0], vs[..., 0, 0]]).reshape(2, -1).contiguous()
    else:
        k, v = k.to(dt), v.to(dt)
    if words[0] == "flash_decode":
        return fa_ops.flash_decode_kernel(q, k, v, lengths, anc, base, scales)
    table = torch.randperm(B * S // ps, generator=g, device=dev).to(torch.int32)
    return fa_ops.flash_decode_paged_kernel(q, k.reshape(B * S, nkv, hd), v.reshape(B * S, nkv, hd), lengths, table,
                                            anc, base, scales, page_size=ps)


@pytest.fixture(scope="module")
def other_libs(cuda):
    if not OTHER:
        pytest.skip("set REPRO_OTHER_CHECKOUT to another checkout's root to compare its builds")
    csrc = Path(OTHER) / "src" / "repro_torch" / "csrc"
    out_dir = kernels.BUILD_DIR / "other"
    return {name: _build(csrc, name, out_dir) for name in ("flash_decode", "flash_attention")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES + PREFILL_CASES)
def test_unchanged_kernels_are_bitwise_the_other_checkouts_on_card(cuda, other_libs, case):
    name = "flash_attention" if case.startswith("flash_attention") else "flash_decode"
    ours = _run(case, cuda)
    with _swapped(name, other_libs[name]):
        theirs = _run(case, cuda)
    assert torch.equal(ours, theirs), case


# ---------------------------------------------------------------------------
# kernel 7: the lo half of P is needed
# ---------------------------------------------------------------------------

P_LO_LINE = "pl[x] = *reinterpret_cast<const uint32_t*>(&lo);"


def _misses(got, want) -> int:
    """Elements outside the bf16 gate of ``test_torch_cuda_kernels._close``
    (and ``chip_smoke.check_bf16``): 2^-7 |plain| + 1e-3 rms."""
    got, want = got.float(), want.float()
    lim = 2.0 ** -7 * want.abs() + 1e-3 * want.pow(2).mean().sqrt()
    return int(((got - want).abs() > lim).sum())


@pytest.mark.cuda
def test_flash_attention_p_needs_its_lo_half_on_card(cuda, tmp_path):
    """RecurrentGemma's prefill shape, q (1, 4096, 10, 256) over one KV head,
    causal, window 2,048: the shipped build holds the gate on every element;
    the same source with P's lo half zeroed misses it on some."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    src = (csrc / "flash_attention.cu").read_text()
    assert src.count(P_LO_LINE) == 1, "the lo half's line moved: update P_LO_LINE"
    (csrc / "flash_attention.cu").write_text(src.replace(P_LO_LINE, "pl[x] = 0u;"))
    hi_only = _build(csrc, "flash_attention", tmp_path / "build")

    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((1, 4096, 10, 256), generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((1, 4096, 1, 256), generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    assert fa_ops.flash_attention_path(q.dtype, 256) == "tensor_cores"
    want = fa_ref.flash_attention(q, k, v, causal=True, window=2048)
    shipped = _misses(fa_ops.flash_attention_kernel(q, k, v, causal=True, window=2048), want)
    with _swapped("flash_attention", hi_only):
        dropped = _misses(fa_ops.flash_attention_kernel(q, k, v, causal=True, window=2048), want)
    print(f"elements outside the bf16 gate of {want.numel()}: hi + lo {shipped}, hi only {dropped}")
    assert shipped == 0
    assert dropped > 0
