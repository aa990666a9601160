"""Fused prefill MoE wrappers (port of ``repro/kernels/moe_fused/ops.py``).

``gather_swiglu`` and ``down_combine`` are the two launches: plain versions
on CPU tensors, ``csrc/moe_fused.cu`` on ``cuda`` tensors, or an error.  On
the card each takes one of two builds, named by :func:`gather_swiglu_path`
and :func:`down_combine_path`: bf16 with d and f multiples of 8 on tensor
cores (wgmma; weights by TMA, and for ``gather_swiglu`` the slots' rows
gathered by cp.async, for ``down_combine`` h's slot tiles by TMA),
everything else on CUDA cores.
:func:`fused_moe_fn` runs a :class:`~repro_torch.core.plans.DispatchPlan`
through both, under an autograd Function whose backward is
:func:`down_combine_bwd` then :func:`gather_swiglu_bwd`
(``csrc/moe_fused_bwd.cu``, fixed order; on the card each takes one of two
builds, named by :func:`down_combine_bwd_path` and
:func:`gather_swiglu_bwd_path`, bf16 with d and f multiples of 8 on tensor
cores, everything else on CUDA cores; their plain versions on the CPU).
The kernel reads x (T, d) and treats index T as a zero row, so the wrapper
builds no padded copy of x.  :func:`fused_experts_fn` runs
slots that are already expert-major (the expert-parallel a2a body's
post-all_to_all tensor) through ``gather_swiglu`` over the identity index
and the grouped GEMM (:mod:`repro_torch.kernels.grouped_gemm`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.plans import DispatchPlan
from repro_torch.kernels.moe_fused import ref

_SIG = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIG_TC = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIG_DOWN = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIG_DOWN_TC = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIG_DOWN_BWD = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIG_GATHER_BWD = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SIG_DOWN_BWD_TC = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SIG_GATHER_BWD_TC = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# f columns of a tile of the dh product, whose per-tile partial dots of d
# slot_w the wrapper's scratch holds (csrc/moe_fused_bwd.cu: BN, tc::BN)
BWD_TILE = {"cuda_cores": 64, "tensor_cores": 256}
BWD_UNIT = 64  # slots a unit of the tensor-core builds' tiles (csrc/moe_fused_bwd.cu tc::UNIT)


def bwd_units_words(E: int, C: int) -> int:
    """int32 words of the tensor-core backwards' unit scratch: each 64-slot
    unit's occupancy, the occupied units' list and each expert's start in it
    (csrc/moe_fused_bwd.cu ``units_kernel``)."""
    n = E * -(-C // BWD_UNIT)
    return 2 * n + E + 1


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"moe_fused: {msg}")


def _cuda_ready(tensors) -> None:
    dev = tensors[0].device
    _check(all(t.device == dev for t in tensors), "tensors on different devices")
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")


def gather_swiglu_path(dtype: torch.dtype, d: int, f: int, aligned: bool) -> str:
    """Which build of kernel 3 a launch takes, from its dtype, d, f and
    whether x, the stacks and h start on 16-byte boundaries:
    ``"tensor_cores"`` (bf16 wgmma tiles; TMA and the 16-byte gather need
    d and f multiples of 8) or ``"cuda_cores"`` (f32 products; f32, and
    bf16 at any other shape)."""
    ok = dtype == torch.bfloat16 and d > 0 and d % 8 == 0 and f % 8 == 0 and aligned
    return "tensor_cores" if ok else "cuda_cores"


def down_combine_path(dtype: torch.dtype, f: int, d: int, aligned: bool) -> str:
    """Which build of kernel 4 a launch takes, from its dtype, f, d and
    whether h and the stack start on 16-byte boundaries: ``"tensor_cores"``
    (bf16 wgmma tiles fed by TMA, which needs h's and Wd's row strides
    multiples of 16 bytes: f and d multiples of 8) or ``"cuda_cores"`` (f32
    products; f32, and bf16 at any other shape)."""
    ok = dtype == torch.bfloat16 and f > 0 and f % 8 == 0 and d % 8 == 0 and aligned
    return "tensor_cores" if ok else "cuda_cores"


def down_combine_bwd_path(dtype: torch.dtype, f: int, d: int, aligned: bool) -> str:
    """Which build of kernel 4's backward a launch takes, from its dtype, f,
    d and whether dy, h and the stack start on 16-byte boundaries:
    ``"tensor_cores"`` (bf16 wgmma tiles fed by TMA: Wd, h, and the slots'
    dy rows and weighted rows as hi + lo pairs, gathered once; row strides
    multiples of 16 bytes, so f and d multiples of 8) or ``"cuda_cores"``
    (f32 products; f32, and bf16 at any other shape)."""
    ok = dtype == torch.bfloat16 and f > 0 and d > 0 and f % 8 == 0 and d % 8 == 0 and aligned
    return "tensor_cores" if ok else "cuda_cores"


def gather_swiglu_bwd_path(dtype: torch.dtype, d: int, f: int, aligned: bool) -> str:
    """Which build of kernel 3's backward a launch takes, from its dtype, d,
    f and whether dh, x and the stacks start on 16-byte boundaries:
    ``"tensor_cores"`` (bf16 wgmma tiles fed by TMA: Wg, Wu, the dg/du hi +
    lo pairs and the slots' x rows, gathered once; d and f multiples of 8)
    or ``"cuda_cores"`` (f32 products; f32, and bf16 at any other shape)."""
    ok = dtype == torch.bfloat16 and f > 0 and d > 0 and f % 8 == 0 and d % 8 == 0 and aligned
    return "tensor_cores" if ok else "cuda_cores"


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def gather_swiglu(
    x: torch.Tensor,         # (T, d)
    flat_idx: torch.Tensor,  # (E*C,) int32 token per slot, T = empty
    w_gate: torch.Tensor,    # (E, d, f)
    w_up: torch.Tensor,
) -> torch.Tensor:
    """h (E, C, f) = silu(x[idx] @ Wg) * (x[idx] @ Wu), in x's type.  On
    the card the launch takes the build :func:`gather_swiglu_path` names."""
    T, d = x.shape
    E, d_, f = w_gate.shape
    _check(d_ == d and w_up.shape == w_gate.shape, f"w_gate/w_up shapes {tuple(w_gate.shape)}, {tuple(w_up.shape)}")
    _check(flat_idx.dtype == torch.int32 and flat_idx.ndim == 1 and flat_idx.numel() % E == 0,
           "flat_idx must be (E*C,) int32")
    _check(x.dtype == w_gate.dtype == w_up.dtype, "x and the expert stacks must share a dtype")
    C = flat_idx.numel() // E
    if x.device.type == "cpu":
        _check(all(t.device.type == "cpu" for t in (flat_idx, w_gate, w_up)), "tensors on different devices")
        return ref.gather_swiglu(x, flat_idx, w_gate, w_up)
    _cuda_ready((x, flat_idx, w_gate, w_up))
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    h = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w_gate, w_up, h))
    if gather_swiglu_path(x.dtype, d, f, aligned) == "tensor_cores":
        rc = function("moe_fused", "repro_gather_swiglu_tc", _SIG_TC)(
            ptr(x), ptr(flat_idx), ptr(w_gate), ptr(w_up), ptr(h), T, E, C, d, f, stream_of(x))
    else:
        rc = function("moe_fused", "repro_gather_swiglu", _SIG)(
            dtype_code(x.dtype), ptr(x), ptr(flat_idx), ptr(w_gate), ptr(w_up), ptr(h),
            T, E, C, d, f, stream_of(x),
        )
    check_launch(rc, "gather_swiglu")
    gather_swiglu.launches += 1
    return h


gather_swiglu.launches = 0


def down_combine(
    h: torch.Tensor,         # (E, C, f)
    w_down: torch.Tensor,    # (E, f, d)
    flat_idx: torch.Tensor,  # (E*C,) int32 destination token per slot, T = empty
    slot_w: torch.Tensor,    # (E*C,) f32 combine weight per slot
    num_tokens: int,
) -> torch.Tensor:
    """y (T, d) f32 = sum over slots of slot_w * (h @ Wd), scattered by
    token.  On the card the down product takes the build
    :func:`down_combine_path` names and writes the occupied slots' weighted
    rows to an (E*C, d) f32 scratch; a second launch sums each token's rows
    in a fixed order (ascending slot), so the result is bitwise repeatable
    (two CUDA launches, counted as one)."""
    E, C, f = h.shape
    d = w_down.shape[-1]
    _check(w_down.shape == (E, f, d), f"w_down shape {tuple(w_down.shape)}")
    _check(flat_idx.dtype == torch.int32 and flat_idx.shape == (E * C,), "flat_idx must be (E*C,) int32")
    _check(slot_w.dtype == torch.float32 and slot_w.shape == (E * C,), "slot_w must be (E*C,) f32")
    _check(h.dtype == w_down.dtype, "h and w_down must share a dtype")
    if h.device.type == "cpu":
        _check(all(t.device.type == "cpu" for t in (w_down, flat_idx, slot_w)), "tensors on different devices")
        return ref.down_combine(h, w_down, flat_idx, slot_w, num_tokens)
    _cuda_ready((h, w_down, flat_idx, slot_w))
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    rows = torch.empty((E * C, d), dtype=torch.float32, device=h.device)
    out = torch.empty((num_tokens, d), dtype=torch.float32, device=h.device)
    args = (ptr(h), ptr(w_down), ptr(flat_idx), ptr(slot_w), ptr(rows), ptr(out), num_tokens, E, C, d, f,
            stream_of(h))
    if down_combine_path(h.dtype, f, d, h.data_ptr() % 16 == 0 and w_down.data_ptr() % 16 == 0) == "tensor_cores":
        rc = function("moe_fused", "repro_down_combine_tc", _SIG_DOWN_TC)(*args)
    else:
        rc = function("moe_fused", "repro_down_combine", _SIG_DOWN)(dtype_code(h.dtype), *args)
    check_launch(rc, "down_combine")
    down_combine.launches += 1
    return out


down_combine.launches = 0


def down_combine_bwd(
    dy: torch.Tensor,        # (T, d) f32, the gradient of down_combine's output
    h: torch.Tensor,         # (E, C, f)
    w_down: torch.Tensor,    # (E, f, d)
    flat_idx: torch.Tensor,  # (E*C,) int32, T = empty
    slot_w: torch.Tensor,    # (E*C,) f32
):
    """Kernel 4's backward (4_bwd): ``(dh, dw_down, dslot_w)``, dh (E, C,
    f) and dw_down (E, f, d) in h's type, dslot_w (E*C,) f32.  dh = slot_w
    (dy[idx] Wd^T), dWd[e] = h[e]^T (slot_w dy[idx]) over slots in
    ascending order, d slot_w = <h, dy[idx] Wd^T>: the dot against the
    unweighted row the dh launch forms, summed over its tiles of f columns
    (``BWD_TILE``) in ascending order (no product recomputed, nothing saved
    by the forward).  An empty slot gets zeros.  On the card the build
    :func:`down_combine_bwd_path` names, its scratch allocated here, counted
    once: three launches on CUDA cores (dh, dWd, the tiles' sum), five on
    tensor cores (the occupied slot units, the slots' dy rows and their
    weighted rows gathered as bf16 hi + lo pairs, dh, dWd, the sum)."""
    E, C, f = h.shape
    d = w_down.shape[-1]
    T = dy.shape[0]
    _check(dy.dtype == torch.float32 and dy.ndim == 2 and dy.shape[1] == d, f"dy must be (T, {d}) f32")
    _check(w_down.shape == (E, f, d) and w_down.dtype == h.dtype, f"w_down {tuple(w_down.shape)} {w_down.dtype}")
    _check(flat_idx.dtype == torch.int32 and flat_idx.shape == (E * C,), "flat_idx must be (E*C,) int32")
    _check(slot_w.dtype == torch.float32 and slot_w.shape == (E * C,), "slot_w must be (E*C,) f32")
    if h.device.type == "cpu":
        _check(all(t.device.type == "cpu" for t in (dy, w_down, flat_idx, slot_w)), "tensors on different devices")
        return ref.down_combine_bwd(dy, h, w_down, flat_idx, slot_w)
    _cuda_ready((dy, h, w_down, flat_idx, slot_w))
    out = _launch_down_combine_bwd(dy, h, w_down, flat_idx, slot_w)
    down_combine_bwd.launches += 1
    return out


def _launch_down_combine_bwd(dy, h, w_down, flat_idx, slot_w):
    """4_bwd's C entry, the build :func:`down_combine_bwd_path` names, on
    the wrapper's checked tensors, with its outputs and scratch allocated
    here; a refused launch raises."""
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    E, C, f = h.shape
    T, d = dy.shape
    dev = h.device
    path = down_combine_bwd_path(h.dtype, f, d, _aligned(dy, h, w_down))
    part = torch.empty((E * C * -(-f // BWD_TILE[path]),), dtype=torch.float32, device=dev)
    dh, dwd = torch.empty_like(h), torch.empty_like(w_down)
    dsw = torch.empty((E * C,), dtype=torch.float32, device=dev)
    if path == "tensor_cores":
        units = torch.empty((bwd_units_words(E, C),), dtype=torch.int32, device=dev)
        rpairs, spairs = (torch.empty((2 * E * C * d,), dtype=torch.bfloat16, device=dev) for _ in range(2))
        rc = function("moe_fused_bwd", "repro_down_combine_bwd_tc", _SIG_DOWN_BWD_TC)(
            ptr(dy), ptr(h), ptr(w_down), ptr(flat_idx), ptr(slot_w), ptr(units), ptr(rpairs), ptr(spairs), ptr(part),
            ptr(dh), ptr(dwd), ptr(dsw), T, E, C, d, f, stream_of(h))
    else:
        rc = function("moe_fused_bwd", "repro_down_combine_bwd", _SIG_DOWN_BWD)(
            dtype_code(h.dtype), ptr(dy), ptr(h), ptr(w_down), ptr(flat_idx), ptr(slot_w), ptr(part), ptr(dh),
            ptr(dwd), ptr(dsw), T, E, C, d, f, stream_of(h))
    check_launch(rc, "down_combine_bwd")
    return dh, dwd, dsw


down_combine_bwd.launches = 0


def gather_swiglu_bwd(
    dh: torch.Tensor,         # (E, C, f), the gradient of gather_swiglu's output
    x: torch.Tensor,          # (T, d)
    flat_idx: torch.Tensor,   # (E*C,) int32, T = empty
    flat_cidx: torch.Tensor,  # (T*k,) int32 slot of each assignment, E*C = dropped
    w_gate: torch.Tensor,     # (E, d, f)
    w_up: torch.Tensor,
):
    """Kernel 3's backward (3_bwd): ``(dx, dw_gate, dw_up)`` in x's type.
    g = xs Wg and u = xs Wu are recomputed per (expert, slot tile); dg = dh
    u silu'(g), du = dh silu(g); dWg[e] = xs[e]^T dg[e], dWu[e] = xs[e]^T
    du[e] over slots in ascending order; dxs = dg Wg^T + du Wu^T; dx[t] =
    the sum of its slots' rows in ascending j of the combine words (a gather
    per token).  On the card the build :func:`gather_swiglu_bwd_path`
    names, its scratch allocated here, counted once: four launches on CUDA
    cores (dg/du, dWg/dWu, dxs, dx over f32 dg/du and dxs scratches), six on
    tensor cores (the occupied slot units, the slots' x rows gathered
    into the dxs scratch, dg/du written as bf16 hi + lo pairs, dWg/dWu, dxs,
    dx)."""
    E, C, f = dh.shape
    T, d = x.shape
    _check(w_gate.shape == (E, d, f) and w_up.shape == w_gate.shape, f"w_gate/w_up shapes {tuple(w_gate.shape)}")
    _check(x.dtype == dh.dtype == w_gate.dtype == w_up.dtype, "dh, x and the expert stacks must share a dtype")
    _check(flat_idx.dtype == torch.int32 and flat_idx.shape == (E * C,), "flat_idx must be (E*C,) int32")
    _check(flat_cidx.dtype == torch.int32 and flat_cidx.ndim == 1 and T > 0 and flat_cidx.numel() % T == 0,
           "flat_cidx must be (T*k,) int32")
    k = flat_cidx.numel() // T
    if x.device.type == "cpu":
        _check(all(t.device.type == "cpu" for t in (dh, flat_idx, flat_cidx, w_gate, w_up)),
               "tensors on different devices")
        return ref.gather_swiglu_bwd(dh, x, flat_idx, flat_cidx, w_gate, w_up)
    _cuda_ready((dh, x, flat_idx, flat_cidx, w_gate, w_up))
    out = _launch_gather_swiglu_bwd(dh, x, flat_idx, flat_cidx, w_gate, w_up)
    gather_swiglu_bwd.launches += 1
    return out


def _launch_gather_swiglu_bwd(dh, x, flat_idx, flat_cidx, w_gate, w_up):
    """3_bwd's C entry, the build :func:`gather_swiglu_bwd_path` names, on
    the wrapper's checked tensors, with its outputs and scratches allocated
    here; a refused launch raises."""
    from repro_torch.kernels import check_launch, dtype_code, function, ptr, stream_of

    E, C, f = dh.shape
    T, d = x.shape
    dev = x.device
    k = flat_cidx.numel() // T
    dxs = torch.empty((E * C * d,), dtype=torch.float32, device=dev)
    dx, dwg, dwu = torch.empty_like(x), torch.empty_like(w_gate), torch.empty_like(w_up)
    if gather_swiglu_bwd_path(x.dtype, d, f, _aligned(dh, x, w_gate, w_up)) == "tensor_cores":
        units = torch.empty((bwd_units_words(E, C),), dtype=torch.int32, device=dev)
        dgu = torch.empty((4 * E * C * f,), dtype=torch.bfloat16, device=dev)  # the bytes of an f32 dg and du
        rc = function("moe_fused_bwd", "repro_gather_swiglu_bwd_tc", _SIG_GATHER_BWD_TC)(
            ptr(dh), ptr(x), ptr(flat_idx), ptr(flat_cidx), ptr(w_gate), ptr(w_up), ptr(units), ptr(dgu), ptr(dxs),
            ptr(dx), ptr(dwg), ptr(dwu), T, E, C, d, f, k, stream_of(x))
    else:
        dgu = torch.empty((2 * E * C * f,), dtype=torch.float32, device=dev)
        rc = function("moe_fused_bwd", "repro_gather_swiglu_bwd", _SIG_GATHER_BWD)(
            dtype_code(x.dtype), ptr(dh), ptr(x), ptr(flat_idx), ptr(flat_cidx), ptr(w_gate), ptr(w_up), ptr(dgu),
            ptr(dxs), ptr(dx), ptr(dwg), ptr(dwu), T, E, C, d, f, k, stream_of(x))
    check_launch(rc, "gather_swiglu_bwd")
    return dx, dwg, dwu


gather_swiglu_bwd.launches = 0


class _FusedMoeTrain(torch.autograd.Function):
    """Kernels 3 and 4 with their gradient: the forward is the two
    launches (saving h), the backward launches :func:`down_combine_bwd`
    then :func:`gather_swiglu_bwd` (on the CPU every half is a plain
    version; on the card none ever is).  The plan's integer words carry no
    gradient; slot_w's reaches the router through the plan's scatter."""

    @staticmethod
    def forward(ctx, x, flat_idx, slot_w, w_gate, w_up, w_down, flat_cidx):
        h = gather_swiglu(x, flat_idx, w_gate, w_up)
        y = down_combine(h, w_down, flat_idx, slot_w, x.shape[0])
        ctx.save_for_backward(x, flat_idx, slot_w, w_gate, w_up, w_down, flat_cidx, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, flat_idx, slot_w, w_gate, w_up, w_down, flat_cidx, h = ctx.saved_tensors
        dh, dwd, dsw = down_combine_bwd(dy.contiguous(), h, w_down, flat_idx, slot_w)
        dx, dwg, dwu = gather_swiglu_bwd(dh, x, flat_idx, flat_cidx, w_gate, w_up)
        return dx, None, dsw, dwg, dwu, dwd, None


def fused_moe_train(x: torch.Tensor, flat_idx: torch.Tensor, slot_w: torch.Tensor, p, flat_cidx: torch.Tensor):
    """The two launches on flat words under :class:`_FusedMoeTrain`, (T, d)
    -> (T, d) f32, serving and training alike (with no gradient asked for
    no graph is kept): ``flat_idx`` / ``slot_w`` the slots' words and
    ``flat_cidx`` each assignment's slot, the slots' count for a dropped
    one (or, in the expert-parallel psum body, for another rank's).  Under
    autograd x, ``slot_w`` and the three stacks get their gradient from
    4_bwd and 3_bwd.  The stacks are cast to x's type first (the f32
    master weights' bf16 use; a no-op when serving)."""
    w = [p[n].to(x.dtype).contiguous() for n in ("w_gate", "w_up", "w_down")]
    return _FusedMoeTrain.apply(x.contiguous(), flat_idx.contiguous(), slot_w.contiguous(), *w,
                                flat_cidx.contiguous())


def fused_moe_apply(x, flat_idx, slot_w, w_gate, w_up, w_down) -> torch.Tensor:
    """Full plan-steered expert pipeline, (T, d) -> (T, d), two launches."""
    h = gather_swiglu(x, flat_idx, w_gate, w_up)
    return down_combine(h, w_down, flat_idx, slot_w, x.shape[0]).to(x.dtype)


def fused_moe_fn(x: torch.Tensor, plan: DispatchPlan, p) -> torch.Tensor:
    """Plan-level entry point used by :func:`repro_torch.models.moe.moe_ffn`,
    (T, d) -> (T, d) f32: :func:`fused_moe_train` on the plan's flat
    words."""
    cidx, _ = plan.flat_combine_words()
    return fused_moe_train(x, plan.flat_dispatch_idx(), plan.flat_slot_w(), p, cidx)


class _FusedExperts(torch.autograd.Function):
    """Kernel 3 over the identity index, then kernel 8, with their gradient:
    the backward launches :func:`~repro_torch.kernels.grouped_gemm.ops.
    grouped_gemm_bwd` (8_bwd: dh and dWd) then :func:`gather_swiglu_bwd`
    with the identity as both its slot and its combine words (k = 1, T =
    E*C: every slot its own token), so 3_bwd gives dx, dWg and dWu."""

    @staticmethod
    def forward(ctx, xf, ident, w_gate, w_up, w_down):
        from repro_torch.kernels.grouped_gemm import grouped_gemm

        E = w_gate.shape[0]
        h = gather_swiglu(xf, ident, w_gate, w_up)
        y = grouped_gemm(h, w_down)
        ctx.save_for_backward(xf, ident, w_gate, w_up, w_down, h)
        return y.reshape(E, -1, y.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels.grouped_gemm.ops import grouped_gemm_bwd

        xf, ident, w_gate, w_up, w_down, h = ctx.saved_tensors
        dh, dwd = grouped_gemm_bwd(h, w_down, dy.contiguous())
        dx, dwg, dwu = gather_swiglu_bwd(dh, xf, ident, ident, w_gate, w_up)
        return dx, None, dwg, dwu, dwd


def fused_experts_fn(x_slots: torch.Tensor, p) -> torch.Tensor:
    """``experts_fn`` over expert-major slots (E, C, d) -> (E, C, d): one
    ``gather_swiglu`` launch over the identity index (every slot occupied, so
    every expert's gate/up weights are read) and one grouped down projection;
    the output stays slot-major, no scatter (reference
    ``moe_fused/ops.fused_experts_fn``).  Under autograd the slots and the
    three stacks get their gradient from 8_bwd and 3_bwd
    (:class:`_FusedExperts`); the stacks are cast to the slots' type first
    (the f32 master weights' bf16 use; a no-op when serving)."""
    E, C, d = x_slots.shape
    flat_idx = torch.arange(E * C, dtype=torch.int32, device=x_slots.device)
    w = [p[n].to(x_slots.dtype).contiguous() for n in ("w_gate", "w_up", "w_down")]
    return _FusedExperts.apply(x_slots.reshape(E * C, d).contiguous(), flat_idx, *w)
