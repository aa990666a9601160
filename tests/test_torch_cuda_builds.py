"""PyTorch port, on the card: kernels run through a second build of their
sources, its library swapped in under the same wrappers.

* Parity with another checkout: the kernels a change leaves alone give
  bitwise what that checkout's build gives on the same inputs: the window
  flash-decode (kernel 6; f32, bf16, int8 K/V), the contiguous and paged
  decode (kernels 1 and 5 at hd 128, tree words; f32, bf16, int8 K/V: the
  head dims 96 and 160 added instantiations and a P.V guard that the
  power-of-two builds never take), both builds of kernel 7
  (CUDA cores: f32 at every head dim, 96 and 160 included, bf16 at 16 and
  32; tensor cores: bf16 at 96, 128, 160 and 256, whose template now also
  builds hd 64 in a branch of its own), both builds of kernel 8 (CUDA cores: f32, and bf16
  at a ragged shape; tensor cores: bf16 at M tiles of 16, 64 and 256, its
  main loop now shared with kernel 4 through ``csrc/grouped_tc.cuh``),
  both builds of kernel 11 (CUDA cores: f32, also at Mamba-2-2.7B's
  widths, and bf16 at a shape the tensor cores do not take; tensor cores:
  bf16 at Mamba-2-2.7B's admission and at a ragged T from h0 over 3
  heads), kernel 11's backward's CUDA-core build (f32, also at Mamba-2-2.7B's
  widths, and bf16 at a shape the tensor cores do not take; its
  tensor-core build is new), both builds of kernel 3 (CUDA
  cores: f32, and bf16 at f 84; tensor cores: bf16 at slot tiles of 16 and
  64) and kernel 4's CUDA-core build (f32, and bf16 at f 84; its bf16
  tensor-core build is new), kernels 9 and 10 (f32 and bf16, rows of whole
  16-byte vectors and not; their sources now also hold 10's backward, and
  kernel 8's its backward, whose builds are new).  The C entry points
  ``repro_flash_decode``, ``repro_flash_decode_paged``,
  ``repro_flash_decode_window``, ``repro_flash_attention``,
  ``repro_flash_attention_tc``, ``repro_grouped_gemm``,
  ``repro_grouped_gemm_tc``, ``repro_ssd_scan``, ``repro_gather_swiglu``,
  ``repro_gather_swiglu_tc``, ``repro_down_combine``, ``repro_moe_dispatch``
  and ``repro_moe_combine`` must keep their signatures in both trees.  Kernel 7's backward's CUDA-core build
  (``repro_flash_attention_bwd`` in the library ``flash_attention_bwd``:
  f32 at every head dim, bf16 at 16 and 32) is held against the other
  checkout too; its tensor-core build (``repro_flash_attention_bwd_tc``,
  bf16 at 64, 96, 128, 160 and, new, 256) is not.  The library is also built alone
  with the package's flags.
  Skips unless ``REPRO_OTHER_CHECKOUT`` names the other checkout's root:

      REPRO_OTHER_CHECKOUT=/path/to/other PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_builds.py

* Kernel 7's tensor-core path carries P into P.V as hi + lo bf16 halves.
  Built with the lo half zeroed (bf16 P alone), it misses the bf16 gate at
  RecurrentGemma's prefill shape (hd 256) and StableLM-12B's (hd 160),
  which the shipped build holds.  The hd 64 branch carries P the same way;
  its misses with the lo half zeroed at MusicGen-large's prompt are
  counted.  Kernel
  11's tensor-core build carries S, the state and w o x the same way;
  built with its lo halves zeroed it misses the 1e-4 gate at Mamba-2-2.7B's
  admission shape.  Kernel 7's backward's tensor-core build carries P and
  dS the same way; with both lo halves zeroed it misses the bf16 gate on
  dV (through P) and on dQ and dK (through dS) at StarCoder2-3B's,
  StableLM-12B's and RecurrentGemma-2B's training heads.  Kernels 3 and 4's backwards' tensor-core
  builds carry dy, the weighted slot rows and dg/du the same way; with
  either set of lo halves zeroed the outputs they feed miss their gates.
  Kernel 11's backward's tensor-core build carries dy, the states and
  their gradients, S and the scaled rows (exp(cum) o dy, w o x) the same
  way; with each set of lo halves zeroed some gradient misses its gate at
  Mamba-2-2.7B's training shape.
  Those backwards' CUDA-core builds (``repro_down_combine_bwd``,
  ``repro_gather_swiglu_bwd`` in the library ``moe_fused_bwd``: f32, and
  bf16 at a d or f not a multiple of 8) are held against the other
  checkout too; their tensor-core builds are new.
* Kernel 8's backward (8_bwd) is the one build this change redesigns: its
  tensor-core entry ``repro_grouped_gemm_bwd_tc`` (dx and dw on new kernels,
  dw's schedule a new argument from the host) is not compared.  Everything else is held bitwise against the other
  checkout, ``csrc/sm90.cuh``'s additions notwithstanding: besides the cases
  above, 8_bwd's CUDA-core build (``repro_grouped_gemm_bwd``: f32, and bf16
  at K 20), kernel 2 (f32, bf16, int8 stacks), and the tensor-core builds of
  kernel 4, of kernel 7's backward (hd 64, 128, 256), of kernels 3 and 4's
  backwards and of kernel 11's backward, and 10_bwd with 9's backward
  (``LEFT_ALONE_CASES``).

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
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

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

WINDOW_CASES = [f"flash_decode_window {kind}{tag}" for tag in ("float32", "bfloat16") for kind in ("", "int8 ")]
# kernels 1 and 5 at Qwen3-MoE's head dim (tree 2,1 words, a scrambled block table)
DECODE_CASES = [f"flash_decode {kind}{tag} {policy}" for tag in ("float32", "bfloat16") for kind in ("", "int8 ")
                for policy in ("contiguous", "paged")]
# kernel 7: f32 at every head dim and bf16 at 16 and 32 (CUDA cores), bf16
# at 96-256 (the tensor-core template; its hd 64 branch is new, not compared)
PREFILL_CASES = [f"flash_attention {tag} hd {hd} window {w}"
                 for tag, hds in (("float32", (16, 32, 64, 96, 128, 160, 256)),
                                  ("bfloat16", (16, 32, 96, 128, 160, 256)))
                 for hd in hds for w in (0, 45)]
# E,M,K,N; "tc" names a case of the tensor-core build
GEMM_CASES = [f"grouped_gemm {tag} {shape}" for tag, shape in
              (("float32", "3,37,100,130"), ("float32", "4,20,1536,4096"), ("bfloat16", "3,37,100,130"),
               ("bfloat16", "128,16,1536,4096 tc"), ("bfloat16", "4,8,200,328 tc"), ("bfloat16", "3,37,200,328 tc"),
               ("bfloat16", "2,300,200,328 tc"))]
# B,T,H,P,N and whether from a random h0; "tc" names a case of the
# forward's tensor-core build
SSD_CASES = [f"ssd_scan {tag} {shape}" for tag, shape in
             (("float32", "2,37,3,16,16,1"), ("float32", "1,2100,80,64,128,1"), ("float32", "1,4096,80,64,128,0"),
              ("bfloat16", "2,300,2,32,64,1"), ("bfloat16", "1,4096,80,64,128,0 tc"),
              ("bfloat16", "2,700,3,64,128,1 tc"))]
# kernel 11's backward on its CUDA-core build (B,T,H,P,N, with h0 and
# dh_final or not): f32, also at Mamba-2-2.7B's widths, and bf16 at a shape
# the tensor cores do not take
SSD_BWD_CASES = [f"ssd_scan_bwd {tag} {shape}" for tag, shape in
                 (("float32", "2,133,3,16,16,1"), ("float32", "1,2100,80,64,128,1"), ("bfloat16", "2,70,5,8,12,1"))]
# T,E,C,d,f
MOE_CASES = [f"{name} {tag} {shape}" for name in ("gather_swiglu", "down_combine") for tag, shape in
             (("float32", "40,8,7,96,80"), ("float32", "128,128,16,4096,1536"), ("bfloat16", "40,8,16,96,84"))] + \
            [f"gather_swiglu bfloat16 {shape} tc" for shape in ("128,128,16,4096,1536", "40,8,40,96,80")]
# kernel 7's backward on its CUDA-core build: f32 at every head dim, bf16
# at the head dims the tensor cores do not take (bf16 at hd 256 left with
# its move to the tensor cores)
BWD_CASES = [f"flash_attention_bwd {tag} hd {hd} window {w}"
             for tag, hds in (("float32", (16, 32, 64, 96, 128, 160, 256)), ("bfloat16", (16, 32)))
             for hd in hds for w in (0, 45)]
# kernels 3 and 4's backwards on their CUDA-core builds (T,E,C,d,f): f32, and
# bf16 at a d or an f the tensor cores do not take
MOE_BWD_CASES = [f"moe_fused_bwd {tag} {shape}" for tag, shape in
                 (("float32", "300,6,104,72,136"), ("float32", "256,16,80,128,192"), ("bfloat16", "50,6,24,20,36"),
                  ("bfloat16", "300,6,104,72,84"))]
# kernels 9 and 10 (T,d,E,k,C): a dispatch, then a combine of its slots
DISPATCH_CASES = [f"moe_dispatch {tag} {shape}" for tag in ("float32", "bfloat16")
                  for shape in ("37,24,8,2,8", "50,20,6,2,24", "96,1024,32,8,32")]
# the builds this change leaves alone beside the one it redesigns (8_bwd's
# tensor cores): 8_bwd on CUDA cores (E,M,K,N: f32, and bf16 at K 20); kernel
# 2 (T,E,k,d,f: f32, bf16, int8 stacks); the tensor-core builds of kernel 4,
# of 7_bwd (hd 64, 128, 256), of 3_bwd / 4_bwd and of 11_bwd; 10_bwd and
# 9's backward (T,d,E,k,C)
LEFT_ALONE_CASES = (
    [f"grouped_gemm_bwd {tag} {shape}" for tag, shape in
     (("float32", "3,37,20,40"), ("float32", "2,320,136,264"), ("bfloat16", "3,37,20,40"))]
    + [f"moe_decode {tag} 16,128,8,1024,384" for tag in ("float32", "bfloat16", "int8 bfloat16")]
    + [f"down_combine bfloat16 {shape} tc" for shape in ("40,8,40,96,80", "128,128,16,4096,1536")]
    + [f"flash_attention_bwd bfloat16 hd {hd} window {w} tc" for hd in (64, 128, 256) for w in (0, 45)]
    + [f"moe_fused_bwd bfloat16 {shape} tc" for shape in ("300,6,104,72,136", "256,16,80,128,192")]
    + ["ssd_scan_bwd bfloat16 2,300,3,64,128,1 tc"]
    + [f"moe_combine_bwd {tag} 50,20,6,2,24" for tag in ("float32", "bfloat16")])
SOURCE = {"grouped_gemm_bwd": "grouped_gemm", "moe_decode": "moe_decode", "moe_combine_bwd": "moe_dispatch","moe_dispatch": "moe_dispatch", "flash_decode_window": "flash_decode", "flash_decode": "flash_decode", "flash_attention": "flash_attention", "grouped_gemm": "grouped_gemm",
          "ssd_scan": "ssd_scan", "gather_swiglu": "moe_fused", "down_combine": "moe_fused",
          "flash_attention_bwd": "flash_attention_bwd", "moe_fused_bwd": "moe_fused_bwd", "ssd_scan_bwd": "ssd_scan"}


def _run(case: str, dev) -> torch.Tensor:
    """One wrapper launch of ``case`` on inputs made from a seed."""
    from repro_torch.core.control_plane import route_topk
    from repro_torch.core.quant import quantize_int8
    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.kernels.moe_fused import ops as mf_ops

    g = torch.Generator(device=dev).manual_seed(len(case))
    words = case.split()
    dt = getattr(torch, words[1] if words[1] != "int8" else words[2])
    if words[0] == "flash_attention":
        hd, window = int(words[3]), int(words[5])
        Sq, nq, nkv = (1200, 10, 1) if hd == 256 else (197, 16, 4)
        q = torch.randn((1, Sq, nq, hd), generator=g, device=dev).to(dt)
        k, v = (torch.randn((1, Sq, nkv, hd), generator=g, device=dev).to(dt) for _ in range(2))
        return fa_ops.flash_attention_kernel(q, k, v, causal=True, window=window)
    if words[0] == "flash_attention_bwd":
        hd, window = int(words[3]), int(words[5])
        S, nq, nkv = (300, 10, 1) if hd == 256 else (197, 16, 4)
        q, do = (torch.randn((1, S, nq, hd), generator=g, device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn((1, S, nkv, hd), generator=g, device=dev).to(dt) for _ in range(2))
        assert fa_ops.flash_attention_bwd_path(dt, hd) == ("tensor_cores" if "tc" in words else "cuda_cores")
        out, lse = fa_ops.flash_attention_lse_kernel(q, k, v, causal=True, window=window)
        grads = fa_ops.flash_attention_bwd_kernel(q, k, v, out, lse, do, causal=True, window=window)
        return torch.cat([t.reshape(-1) for t in grads])
    if words[0] == "moe_fused_bwd":
        from repro_torch.core.control_plane import route_topk
        from repro_torch.kernels.moe_fused import ops as mf_ops

        T, E, C, d, f = (int(n) for n in words[2].split(","))
        x = torch.randn((T, d), generator=g, device=dev)
        plan, _ = route_topk(x, torch.randn((d, E), generator=g, device=dev), 2, C)
        wg, wu = ((torch.randn((E, d, f), generator=g, device=dev) * d ** -0.5).to(dt) for _ in range(2))
        wd = (torch.randn((E, f, d), generator=g, device=dev) * f ** -0.5).to(dt)
        x, dy = x.to(dt), torch.randn((T, d), generator=g, device=dev)
        assert mf_ops.down_combine_bwd_path(dt, f, d, True) == mf_ops.gather_swiglu_bwd_path(dt, d, f, True) \
            == ("tensor_cores" if "tc" in words else "cuda_cores")
        h = mf_ops.gather_swiglu(x, plan.flat_idx, wg, wu)
        dh, dwd, dsw = mf_ops.down_combine_bwd(dy, h, wd, plan.flat_idx, plan.slot_w)
        grads = mf_ops.gather_swiglu_bwd(dh, x, plan.flat_idx, plan.flat_cidx, wg, wu)
        return torch.cat([t.reshape(-1).float() for t in (dh, dwd, dsw, *grads)])
    if words[0] == "moe_dispatch":
        from repro_torch.kernels.moe_dispatch import ops as md_ops

        T, d, E, k, C = (int(n) for n in words[2].split(","))
        x = torch.randn((T, d), generator=g, device=dev)
        plan, _ = route_topk(x, torch.randn((d, E), generator=g, device=dev), k, C)
        slots = md_ops.dispatch(x.to(dt), plan)
        y = md_ops.combine((slots.float() * 1.5).to(dt), plan)
        return torch.cat([slots.reshape(-1).float(), y.reshape(-1).float()])
    if words[0] == "grouped_gemm_bwd":
        E, M, K, N = (int(n) for n in words[2].split(","))
        x, dy = (torch.randn(s, generator=g, device=dev).to(dt) for s in ((E, M, K), (E, M, N)))
        w = (torch.randn((E, K, N), generator=g, device=dev) / K ** 0.5).to(dt)
        assert gg_ops.grouped_gemm_bwd_path(dt, K, N, True) == "cuda_cores"
        return torch.cat([t.reshape(-1) for t in gg_ops.grouped_gemm_bwd(x, w, dy)])
    if words[0] == "moe_decode":
        from repro_torch.kernels.moe_decode import ops as dm_ops

        T, E, k, d, f = (int(n) for n in words[-1].split(","))
        ids = torch.stack([torch.randperm(E, generator=g, device=dev)[:k] for _ in range(T)]).to(torch.int32)
        wts = torch.softmax(torch.randn((T, k), generator=g, device=dev), -1)
        stacks = [torch.randn(sh, generator=g, device=dev) * a for sh, a in
                  (((E, d, f), d ** -0.5), ((E, d, f), d ** -0.5), ((E, f, d), f ** -0.5))]
        x = torch.randn((T, d), generator=g, device=dev)
        if words[1] == "int8":
            twins = [quantize_int8(st, axis=(1, 2)) for st in stacks]
            stacks, scales = [q_ for q_, _ in twins], torch.stack([sc[:, 0, 0] for _, sc in twins]).contiguous()
        else:
            stacks, scales = [st.to(dt) for st in stacks], None
        x = x.to(dt)
        return dm_ops.decode_moe_kernel(x, ids, wts.contiguous(), *stacks, scales)
    if words[0] == "moe_combine_bwd":
        from repro_torch.kernels.moe_dispatch import ops as md_ops

        T, d, E, k, C = (int(n) for n in words[2].split(","))
        x = torch.randn((T, d), generator=g, device=dev)
        plan, _ = route_topk(x, torch.randn((d, E), generator=g, device=dev), k, C)
        cidx, w = plan.flat_combine_words()
        idx = plan.flat_dispatch_idx()
        ys, dy = torch.randn((E, C, d), generator=g, device=dev).to(dt), torch.randn((T, d), generator=g, device=dev).to(dt)
        dslots, dw = md_ops.combine_bwd(dy, ys, cidx, w, idx)
        return torch.cat([dslots.reshape(-1).float(), dw.reshape(-1).float(),
                          md_ops.dispatch_bwd(ys, cidx, T).reshape(-1).float()])
    if words[0] == "grouped_gemm":
        E, M, K, N = (int(n) for n in words[2].split(","))
        x = torch.randn((E, M, K), generator=g, device=dev).to(dt)
        w = (torch.randn((E, K, N), generator=g, device=dev) / K ** 0.5).to(dt)
        assert gg_ops.grouped_gemm_path(dt, K, N, True) == ("tensor_cores" if "tc" in words else "cuda_cores")
        return gg_ops.grouped_gemm(x, w)
    if words[0] == "ssd_scan":
        B, T, H, P, N, with_h0 = (int(n) for n in words[2].split(","))
        proj = (torch.randn((B, T, H * P + 2 * N), generator=g, device=dev) * 0.5).to(dt)
        x, bm, cm = proj[..., :H * P].reshape(B, T, H, P), proj[..., H * P:H * P + N], proj[..., H * P + N:]
        dts = torch.nn.functional.softplus(torch.randn((B, T, H), generator=g, device=dev) - 1.0)
        a = -torch.linspace(1.0, 16.0, H, device=dev)
        h0 = torch.randn((B, H, N, P), generator=g, device=dev) if with_h0 else None
        want = "tensor_cores" if "tc" in words else "cuda_cores"
        assert ssd_ops.ssd_scan_path(dt, N, P, ssd_ops.tma_ready(x, bm, cm)) == want
        return torch.cat([t.reshape(-1) for t in ssd_ops.ssd_scan(x, dts, a, bm, cm, 256, h0=h0)])
    if words[0] == "ssd_scan_bwd":
        B, T, H, P, N, with_state = (int(n) for n in words[2].split(","))
        proj = (torch.randn((B, T, H * P + 2 * N), generator=g, device=dev) * 0.5).to(dt)
        x, bm, cm = proj[..., :H * P].reshape(B, T, H, P), proj[..., H * P:H * P + N], proj[..., H * P + N:]
        dts = torch.nn.functional.softplus(torch.randn((B, T, H), generator=g, device=dev) - 1.0)
        a = -torch.linspace(1.0, 16.0, H, device=dev)
        dy = torch.randn((B, T, H, P), generator=g, device=dev)
        h0, dhf = ((torch.randn((B, H, N, P), generator=g, device=dev), torch.randn((B, H, N, P), generator=g,
                                                                                     device=dev))
                   if with_state else (None, None))
        assert ssd_ops.ssd_scan_bwd_path(dt, N, P, ssd_ops.tma_ready(x, bm, cm)) == \
            ("tensor_cores" if "tc" in words else "cuda_cores")
        grads = ssd_ops.ssd_scan_bwd(x, dts, a, bm, cm, 256, dy, dhf, h0)
        return torch.cat([t.reshape(-1).float() for t in grads if t is not None])
    if words[0] in ("gather_swiglu", "down_combine"):
        T, E, C, d, f = (int(n) for n in words[2].split(","))
        x = torch.randn((T, d), generator=g, device=dev)
        plan, _ = route_topk(x, torch.randn((d, E), generator=g, device=dev), 8 if E > 8 else 2, C)
        w1, w2 = ((torch.randn((E, d, f), generator=g, device=dev) * d ** -0.5).to(dt) for _ in range(2))
        if words[0] == "gather_swiglu":
            assert mf_ops.gather_swiglu_path(dt, d, f, True) == ("tensor_cores" if "tc" in words else "cuda_cores")
            return mf_ops.gather_swiglu(x.to(dt), plan.flat_idx, w1, w2)
        assert mf_ops.down_combine_path(dt, f, d, True) == ("tensor_cores" if "tc" in words else "cuda_cores")
        h = torch.randn((E, C, f), generator=g, device=dev).to(dt)
        return mf_ops.down_combine(h, w1.transpose(1, 2).contiguous(), plan.flat_idx, plan.slot_w, T)
    if words[0] == "flash_decode":
        from repro_torch.core.plans import TreePlan

        B, T, nq, nkv, hd, S, ps = 2, 4, 16, 4, 128, 240, 16
        q = torch.randn((B, T, nq, hd), generator=g, device=dev).to(dt)
        k, v = (torch.randn((B, S, nkv, hd), generator=g, device=dev) for _ in range(2))
        scales = None
        if "int8" in words:
            (k, ks), (v, vs) = (quantize_int8(c, axis=(-2, -1)) for c in (k, v))
            scales = torch.stack([ks[..., 0, 0], vs[..., 0, 0]]).reshape(2, -1).contiguous()
        else:
            k, v = k.to(dt), v.to(dt)
        base = torch.tensor([61, 190], dtype=torch.int32, device=dev)
        lengths = (base[:, None] + torch.arange(1, T + 1, dtype=torch.int32, device=dev)).reshape(-1).contiguous()
        anc = torch.tensor(TreePlan.from_branching((2, 1)).ancestor_words(), dtype=torch.int32, device=dev)
        if words[-1] == "contiguous":
            return fa_ops.flash_decode_kernel(q, k, v, lengths, anc, base, scales)
        table = torch.randperm(B * S // ps, generator=g, device=dev).to(torch.int32)
        return fa_ops.flash_decode_paged_kernel(q, k.reshape(B * S, nkv, hd), v.reshape(B * S, nkv, hd), lengths,
                                                table, anc, base, scales, page_size=ps)
    # the window decode: 4 slots of 10 heads over one KV head, hd 256, a
    # 300-slot rolling buffer, window 160, positions before and past the wrap
    B, nq, nkv, hd, W = 4, 10, 1, 256, 300
    pos = torch.tensor([5, 299, 1000, 1711], dtype=torch.int32, device=dev)
    q = torch.randn((B, 1, nq, hd), generator=g, device=dev).to(dt)
    k, v = (torch.randn((B, W, nkv, hd), generator=g, device=dev) for _ in range(2))
    scales = None
    if "int8" in words:
        (k, ks), (v, vs) = (quantize_int8(c, axis=(-2, -1)) for c in (k, v))
        scales = torch.stack([ks[..., 0, 0], vs[..., 0, 0]]).reshape(2, -1).contiguous()
    else:
        k, v = k.to(dt), v.to(dt)
    return fa_ops.flash_decode_window_kernel(q, k, v, pos, scales, window=160)


@pytest.fixture(scope="module")
def other_libs(cuda):
    if not OTHER:
        pytest.skip("set REPRO_OTHER_CHECKOUT to another checkout's root to compare its builds")
    csrc = Path(OTHER) / "src" / "repro_torch" / "csrc"
    out_dir = kernels.BUILD_DIR / "other"
    return {name: _build(csrc, name, out_dir) for name in set(SOURCE.values())}


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES + DECODE_CASES + PREFILL_CASES + GEMM_CASES + SSD_CASES + MOE_CASES
                         + BWD_CASES + MOE_BWD_CASES + SSD_BWD_CASES + DISPATCH_CASES + LEFT_ALONE_CASES)
def test_unchanged_kernels_are_bitwise_the_other_checkouts_on_card(cuda, other_libs, case):
    name = SOURCE[case.split()[0]]
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
@pytest.mark.parametrize("hd,nq,nkv,window", [(256, 10, 1, 2048), (160, 32, 8, 0)])
def test_flash_attention_p_needs_its_lo_half_on_card(cuda, tmp_path, hd, nq, nkv, window):
    """RecurrentGemma's prefill shape, q (1, 4096, 10, 256) over one KV head,
    causal, window 2,048, and StableLM-12B's, q (1, 4096, 32, 160) over 8
    KV heads, causal: the shipped build holds the gate on every element;
    the same source with P's lo half zeroed misses it on some."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    src = (csrc / "flash_attention.cu").read_text()
    assert src.count(P_LO_LINE) == 1, "the lo half's line moved: update P_LO_LINE"
    (csrc / "flash_attention.cu").write_text(src.replace(P_LO_LINE, "pl[x] = 0u;"))
    hi_only = _build(csrc, "flash_attention", tmp_path / "build")

    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((1, 4096, nq, hd), generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((1, 4096, nkv, hd), generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    assert fa_ops.flash_attention_path(q.dtype, hd) == "tensor_cores"
    want = fa_ref.flash_attention(q, k, v, causal=True, window=window)
    shipped = _misses(fa_ops.flash_attention_kernel(q, k, v, causal=True, window=window), want)
    with _swapped("flash_attention", hi_only):
        dropped = _misses(fa_ops.flash_attention_kernel(q, k, v, causal=True, window=window), want)
    print(f"elements outside the bf16 gate of {want.numel()}: hi + lo {shipped}, hi only {dropped}")
    assert shipped == 0
    assert dropped > 0


P64_LO_LINE = "pl[x] = pack_bf16(s[2 * x] - h0, s[2 * x + 1] - h1);"


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2048, 4096])
def test_flash_attention_hd64_lo_half_misses_on_card(cuda, tmp_path, S):
    """MusicGen-large's heads (32 query and 32 KV heads of 64), one causal
    prompt of 2,048 and of 4,096 tokens: the shipped hd 64 instantiation
    (hi + lo halves of P, its own packing line in the template's hd 64
    branch) holds the bf16 gate on every element; the same source with
    that lo half zeroed is counted (printed), not required to miss."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    src = (csrc / "flash_attention.cu").read_text()
    assert src.count(P64_LO_LINE) == 1, "the hd 64 lo half's line moved: update P64_LO_LINE"
    (csrc / "flash_attention.cu").write_text(src.replace(P64_LO_LINE, "pl[x] = 0u;"))
    hi_only = _build(csrc, "flash_attention", tmp_path / "build")

    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn((1, S, 32, 64), generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    assert fa_ops.flash_attention_path(q.dtype, 64) == "tensor_cores"
    want = fa_ref.flash_attention(q, k, v, causal=True)
    shipped = _misses(fa_ops.flash_attention_kernel(q, k, v, causal=True), want)
    with _swapped("flash_attention", hi_only):
        dropped = _misses(fa_ops.flash_attention_kernel(q, k, v, causal=True), want)
    print(f"hd 64, S {S}: elements outside the bf16 gate of {want.numel()}: hi + lo {shipped}, hi only {dropped}")
    assert shipped == 0


# ---------------------------------------------------------------------------
# kernel 7's backward: the lo halves of P and dS are needed
# ---------------------------------------------------------------------------

BWD_LO_LINE = "lo = *reinterpret_cast<const uint32_t*>(&l);"


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv,hd", [(24, 2, 128), (32, 8, 160), (10, 1, 256)])
def test_flash_attention_bwd_needs_its_lo_halves_on_card(cuda, tmp_path, nq, nkv, hd):
    """StarCoder2-3B's training heads (24 q / 2 kv of 128), StableLM-12B's
    (32 / 8 of 160) and RecurrentGemma-2B's (10 / 1 of 256), one causal
    2,048-token bf16 sequence: the shipped tensor-core build holds the bf16
    gate on every element of dQ, dK and dV; the same source with the lo
    halves of P and dS zeroed misses it on each (dV through P, dQ and dK
    through dS)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    src = (csrc / "flash_attention_bwd.cu").read_text()
    assert src.count(BWD_LO_LINE) == 1, "the lo halves' line moved: update BWD_LO_LINE"
    (csrc / "flash_attention_bwd.cu").write_text(src.replace(BWD_LO_LINE, "lo = 0u;"))
    hi_only = _build(csrc, "flash_attention_bwd", tmp_path / "build")

    g = torch.Generator(device=cuda).manual_seed(28)
    q, do = (torch.randn((1, 2048, nq, hd), generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, 2048, nkv, hd), generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    assert fa_ops.flash_attention_bwd_path(q.dtype, hd) == "tensor_cores"
    out, lse = fa_ops.flash_attention_lse_kernel(q, k, v, causal=True)
    want = fa_ref.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    shipped = [_misses(a, w) for a, w in zip(fa_ops.flash_attention_bwd_kernel(q, k, v, out, lse, do), want)]
    with _swapped("flash_attention_bwd", hi_only):
        dropped = [_misses(a, w) for a, w in zip(fa_ops.flash_attention_bwd_kernel(q, k, v, out, lse, do), want)]
    print(f"dq, dk, dv elements outside the bf16 gate: hi + lo {shipped}, hi only {dropped}")
    assert shipped == [0, 0, 0]
    assert all(n > 0 for n in dropped)


# ---------------------------------------------------------------------------
# kernels 3 and 4's backwards: the lo halves of dy, the weighted rows and
# dg/du are needed
# ---------------------------------------------------------------------------

MOE_BWD_LO_LINES = {
    "dy": ("__floats2bfloat162_rn(v[2 * i] - __low2float(hp), v[2 * i + 1] - __high2float(hp))",),
    "dg/du": ("__floats2bfloat162_rn(dg[0] - __low2float(gh), dg[1] - __high2float(gh))",
              "__floats2bfloat162_rn(du[0] - __low2float(uh), du[1] - __high2float(uh))"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("zeroed", sorted(MOE_BWD_LO_LINES))
def test_moe_backward_lo_halves_misses_on_card(cuda, tmp_path, zeroed):
    """bf16 at a quarter of Qwen3-MoE's widths (T 2,048, d 1,024, f 768, 32
    experts top-8, capacity factor 1.25): the shipped tensor-core builds
    hold the bf16 gate on dh, dWd, dx, dWg and dWu and 1e-4 of the scale on
    d slot_w against the plain versions; built with the lo halves of dy's
    and the weighted slot rows' pairs zeroed (``dy``), dh and dWd miss the
    gate and d slot_w its bound, and with dg/du's zeroed, dx, dWg and dWu
    miss it.  The misses are counted (printed)."""
    from repro_torch.core.control_plane import capacity_for, route_topk
    from repro_torch.kernels.moe_fused import ops as mf_ops
    from repro_torch.kernels.moe_fused import ref as mf_ref

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    src = (csrc / "moe_fused_bwd.cu").read_text()
    for line in MOE_BWD_LO_LINES[zeroed]:
        assert src.count(line) == 1, f"the {zeroed} lo half's line moved: update MOE_BWD_LO_LINES"
        src = src.replace(line, "__floats2bfloat162_rn(0.f, 0.f)")
    (csrc / "moe_fused_bwd.cu").write_text(src)
    hi_only = _build(csrc, "moe_fused_bwd", tmp_path / "build")

    T, d, f, E, k = 2048, 1024, 768, 32, 8
    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn((T, d), generator=g, device=cuda)
    plan, _ = route_topk(x, torch.randn((d, E), generator=g, device=cuda) * 0.02, k, capacity_for(T, E, k, 1.25))
    x = x.to(torch.bfloat16)
    wg, wu = ((torch.randn((E, d, f), generator=g, device=cuda) * d ** -0.5).to(torch.bfloat16) for _ in range(2))
    wd = (torch.randn((E, f, d), generator=g, device=cuda) * f ** -0.5).to(torch.bfloat16)
    dy = torch.randn((T, d), generator=g, device=cuda)
    idx, sw, cidx = plan.flat_idx, plan.slot_w, plan.flat_cidx
    assert mf_ops.down_combine_bwd_path(x.dtype, f, d, True) == "tensor_cores"
    h = mf_ops.gather_swiglu(x, idx, wg, wu)
    want4 = mf_ref.down_combine_bwd(dy, h, wd, idx, sw)
    want3 = mf_ref.gather_swiglu_bwd(want4[0], x, idx, cidx, wg, wu)
    scale = 1e-4 * max(1.0, float(want4[2].abs().max()))

    def counts():
        dh, dwd, dsw = mf_ops.down_combine_bwd(dy, h, wd, idx, sw)
        out = dict(dh=_misses(dh, want4[0]), dwd=_misses(dwd, want4[1]),
                   dslot_w_over_bound=float((dsw - want4[2]).abs().max()) / scale)
        out.update(zip(("dx", "dwg", "dwu"), (_misses(a, w) for a, w in zip(
            mf_ops.gather_swiglu_bwd(want4[0], x, idx, cidx, wg, wu), want3))))
        return out

    shipped = counts()
    with _swapped("moe_fused_bwd", hi_only):
        dropped = counts()
    print(f"{zeroed} lo halves: shipped {shipped}, zeroed {dropped}")
    assert shipped["dslot_w_over_bound"] <= 1.0 and all(shipped[n] == 0 for n in ("dh", "dwd", "dx", "dwg", "dwu"))
    if zeroed == "dy":
        assert dropped["dh"] > 0 and dropped["dwd"] > 0 and dropped["dslot_w_over_bound"] > 1.0
    else:
        assert dropped["dx"] > 0 and dropped["dwg"] > 0 and dropped["dwu"] > 0


# ---------------------------------------------------------------------------
# kernel 11: the lo halves of S, the state and w o x are needed
# ---------------------------------------------------------------------------

SSD_LO_LINE = "lo = *reinterpret_cast<const uint32_t*>(&l);"


@pytest.mark.cuda
def test_ssd_scan_needs_its_lo_halves_on_card(cuda, tmp_path):
    """Mamba-2-2.7B's admission shape, bf16 x, B and C as views of one
    projection (80 heads of 64, N 128, 4,096 steps) from a zero state: the
    shipped tensor-core build holds the 1e-4 gate on y and on the final
    state; the same source with every lo half zeroed misses it on y."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    src = (csrc / "ssd_scan.cu").read_text()
    assert src.count(SSD_LO_LINE) == 1, "the lo halves' line moved: update SSD_LO_LINE"
    (csrc / "ssd_scan.cu").write_text(src.replace(SSD_LO_LINE, "lo = 0u;"))
    hi_only = _build(csrc, "ssd_scan", tmp_path / "build")

    g = torch.Generator(device=cuda).manual_seed(11)
    T, H, P, N = 4096, 80, 64, 128
    proj = (torch.randn((1, T, H * P + 2 * N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    x, bm, cm = proj[..., :H * P].reshape(1, T, H, P), proj[..., H * P:H * P + N], proj[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((1, T, H), generator=g, device=cuda) - 1.0)
    a = -torch.linspace(1.0, 16.0, H, device=cuda)
    assert ssd_ops.ssd_scan_path(x.dtype, N, P, ssd_ops.tma_ready(x, bm, cm)) == "tensor_cores"
    want_y, want_h = ssd_ref.ssd_chunked(x, dt, a, bm, cm, 256)

    def miss(got, want):  # max |got - want| over the gate's allowance
        return float((got - want).abs().max()) / (1e-4 * max(1.0, float(want.abs().max())))

    y, h = ssd_ops.ssd_scan(x, dt, a, bm, cm, 256)
    with _swapped("ssd_scan", hi_only):
        y_hi, h_hi = ssd_ops.ssd_scan(x, dt, a, bm, cm, 256)
    print(f"y / state over the 1e-4 gate: hi + lo {miss(y, want_y):.3f} / {miss(h, want_h):.3f}, "
          f"hi only {miss(y_hi, want_y):.3f} / {miss(h_hi, want_h):.3f}")
    assert miss(y, want_y) <= 1.0 and miss(h, want_h) <= 1.0
    assert miss(y_hi, want_y) > 1.0


# ---------------------------------------------------------------------------
# kernel 11's backward: each set of lo halves its tensor-core build keeps
# is needed
# ---------------------------------------------------------------------------

# the line that makes each set of lo halves, and the same line without them
SSD_BWD_LO_LINES = {
    "dy": ("l[k] = bits(__floats2bfloat162_rn(v[2 * k] - __low2float(hk), v[2 * k + 1] - __high2float(hk)));",
           "l[k] = 0u;"),
    "states": ("l[k] = bits(__floats2bfloat162_rn(x[2 * k] - __low2float(hk), x[2 * k + 1] - __high2float(hk)));",
               "l[k] = 0u;"),
    "S": ("lo = bits(__floats2bfloat162_rn(s0 - __low2float(h), s1 - __high2float(h)));", "lo = 0u;"),
    "rows": ("lo = bits(__floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h)));", "lo = 0u;"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("zeroed", sorted(SSD_BWD_LO_LINES))
def test_ssd_backward_needs_its_lo_halves_on_card(cuda, tmp_path, zeroed):
    """Mamba-2-2.7B's training shape (2 x 2,048 steps, 80 heads of 64, N
    128), bf16 x, B and C as views of one projection, dy f32: the shipped
    tensor-core build holds every gate against the plain backward at chunk
    256 (1e-4 of the scale on ddt and da, the bf16 gate on dx, dB and dC);
    built with one set of lo halves zeroed (dy's tiles in the column
    blocks; the states' and their gradients' planes; S^T; the scaled rows
    exp(cum) o dy and w o x), some gradient misses.  The misses are counted (printed)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    src = (csrc / "ssd_scan.cu").read_text()
    line, hi_only_line = SSD_BWD_LO_LINES[zeroed]
    assert src.count(line) == 1, f"the {zeroed} lo halves' line moved: update SSD_BWD_LO_LINES"
    (csrc / "ssd_scan.cu").write_text(src.replace(line, hi_only_line))
    hi_only = _build(csrc, "ssd_scan", tmp_path / "build")

    g = torch.Generator(device=cuda).manual_seed(34)
    B, T, H, P, N = 2, 2048, 80, 64, 128
    proj = (torch.randn((B, T, H * P + 2 * N), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    x, bm, cm = proj[..., :H * P].reshape(B, T, H, P), proj[..., H * P:H * P + N], proj[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, T, H), generator=g, device=cuda) - 1.0)
    a = -torch.linspace(1.0, 16.0, H, device=cuda)
    dy = torch.randn((B, T, H, P), generator=g, device=cuda)
    assert ssd_ops.ssd_scan_bwd_path(x.dtype, N, P, ssd_ops.tma_ready(x, bm, cm)) == "tensor_cores"
    want = ssd_ref.ssd_chunked_bwd(x, dt, a, bm, cm, 256, dy)

    def misses():  # bf16 outputs: elements off the gate; f32: max |got - want| over the gate's allowance
        got = ssd_ops.ssd_scan_bwd(x, dt, a, bm, cm, 256, dy)
        out = {}
        for name, gv, wv in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
            if gv.dtype == torch.float32:
                out[name] = float((gv - wv).abs().max()) / (1e-4 * max(1.0, float(wv.abs().max())))
            else:
                out[name] = _misses(gv, wv)
        return out

    shipped = misses()
    with _swapped("ssd_scan", hi_only):
        dropped = misses()
    print(f"11_bwd {zeroed} lo halves: shipped {shipped}, zeroed {dropped}")
    assert shipped["ddt"] <= 1.0 and shipped["da"] <= 1.0 and all(shipped[n] == 0 for n in ("dx", "dB", "dC"))
    assert dropped["ddt"] > 1.0 or dropped["da"] > 1.0 or any(dropped[n] > 0 for n in ("dx", "dB", "dC"))


# ---------------------------------------------------------------------------
# the training library
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_training_entries_build_with_the_package_flags_on_card(cuda, tmp_path):
    """``csrc/flash_attention_bwd.cu`` builds alone with the package's
    flags and exports kernel 7's backward, whose CUDA-core entry refuses
    bf16 at the tensor-core head dims before it touches a pointer; kernel
    7's library exports the LSE entries beside the serving ones."""
    lib = _build(kernels.CSRC, "flash_attention_bwd", tmp_path / "build")
    assert hasattr(lib, "repro_flash_attention_bwd") and hasattr(lib, "repro_flash_attention_bwd_tc")
    fn = lib.repro_flash_attention_bwd
    fn.argtypes, fn.restype = fa_ops._FA_BWD_ARGTYPES, ctypes.c_int
    for hd in fa_ops._FA_BWD_TC_HEAD_DIMS:  # B, Sq, Skv, nq, nkv, hd, causal, window, scale, stream
        assert fn(1, *[None] * 10, 1, 64, 64, 10, 1, hd, 1, 0, 1.0, None) == 1, hd  # cudaErrorInvalidValue
    assert "flash_attention_bwd" in kernels.SOURCES
    fa = kernels.library("flash_attention")
    for symbol in ("repro_flash_attention", "repro_flash_attention_tc", "repro_flash_attention_lse",
                   "repro_flash_attention_tc_lse"):
        assert hasattr(fa, symbol), symbol
