"""PyTorch port, kernel 8's backward (``8_bwd``; ``csrc/grouped_gemm.cu``)
on the CPU, where the wrapper runs its plain version.

* The plain backward (``kernels/grouped_gemm/ref.py``: dx = dy w^T and
  dw = x^T dy, f32 sums rounded once) against ``jax.vjp`` of the
  reference's ``grouped_gemm`` (``src/repro/kernels/grouped_gemm/ref.py``)
  and against the same two products through the reference's Pallas kernel
  (``grouped_gemm_pallas`` in interpret mode: its forward, which has no
  VJP), at the tensor-core design's edges: M 320 (dx's two halves of 160
  slots full, dy's slice resident), 129 and 1 (the first half ragged, the
  second past M), 330 (past the resident budget: dy streamed), K 136 (a
  ragged last K tile) and 1,536 (Qwen3-MoE's f over 2 experts), N 264 (a
  ragged last 256-column slice).
  f32 within 1e-5 of the output's scale (sums in other orders); bf16, from
  the same bf16 inputs, elementwise within ``chip_smoke.check_bf16``'s gate
  (one bf16 ulp, 2^-7 |reference|, plus 1e-3 of its rms: both sides sum in
  f32 and round once) against the f32 VJP rounded to bf16 and against the
  Pallas kernel's bf16 products.
* dw's schedule on the tensor-core build (``ops.grouped_gemm_bwd_schedule``,
  from M alone): dy resident at Qwen3-MoE's (320, 1,536, 4,096), streamed
  above 320 slots; the C entry given it by the launch (through a fake
  ``function``: no card here); the shared memory each kernel asks for
  within the budget, with the host's count of resident chunks the C
  source's; the build choice (``grouped_gemm_bwd_path``) unchanged.
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_gemm.kernel import grouped_gemm_pallas
from repro.kernels.grouped_gemm.ref import grouped_gemm as j_grouped_gemm
from repro_torch import kernels
from repro_torch.kernels.grouped_gemm import ops as gg_ops

# E, M, K, N of y[e] = x[e] @ w[e]
SHAPES = {"m320": (2, 320, 136, 264), "m129": (2, 129, 136, 264), "m1": (3, 1, 136, 264),
          "k1536": (2, 320, 1536, 264), "m330_streamed": (2, 330, 136, 264)}


def _inputs(case: str, dtype: torch.dtype):
    E, M, K, N = SHAPES[case]
    rng = np.random.default_rng(M * 7 + K)
    x, w, dy = (rng.standard_normal(s).astype(np.float32) for s in ((E, M, K), (E, K, N), (E, M, N)))
    # bf16 cases: both sides start from the same bf16 values
    return [torch.from_numpy(a).to(dtype) for a in (x, w, dy)]


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _hold(name, got: torch.Tensor, want: np.ndarray):
    """f32: within 1e-5 of the output's scale; bf16: check_bf16's gate."""
    g, w = got.float().numpy(), np.asarray(want, dtype=np.float32)
    assert g.shape == w.shape, name
    err = np.abs(g - w)
    if got.dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * max(1.0, float(np.abs(w).max())), (name, float(err.max()))
    else:
        lim = 2.0 ** -7 * np.abs(w) + 1e-3 * float(np.sqrt((w ** 2).mean()))
        assert int((err > lim).sum()) == 0, (name, float(err.max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_backward_matches_jax_vjp_and_the_pallas_products(case, dtype):
    x, w, dy = _inputs(case, dtype)
    dx, dw = gg_ops.grouped_gemm_bwd(x, w, dy)  # CPU tensors: the plain version
    assert dx.dtype == dw.dtype == dtype and dx.shape == x.shape and dw.shape == w.shape

    # jax.vjp of the reference's einsum in f32 on the (rounded) inputs, rounded once to the dtype
    _, vjp = jax.vjp(j_grouped_gemm, jnp.asarray(_np32(x)), jnp.asarray(_np32(w)))
    want_dx, want_dw = (torch.from_numpy(np.array(a)).to(dtype).float().numpy() for a in vjp(jnp.asarray(_np32(dy))))
    _hold(f"{case} dx vs vjp", dx, want_dx)
    _hold(f"{case} dw vs vjp", dw, want_dw)

    # the same products through the Pallas kernel (f32 VMEM sums, one cast), in the dtype
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jw, jdy = (jnp.asarray(_np32(t)).astype(jdt) for t in (x, w, dy))
    p_dx = grouped_gemm_pallas(jdy, jnp.swapaxes(jw, 1, 2), interpret=True)
    p_dw = grouped_gemm_pallas(jnp.swapaxes(jx, 1, 2), jdy, interpret=True)
    _hold(f"{case} dx vs pallas", dx, np.asarray(p_dx.astype(jnp.float32)))
    _hold(f"{case} dw vs pallas", dw, np.asarray(p_dw.astype(jnp.float32)))


def test_cases_reach_each_schedule():
    assert {gg_ops.grouped_gemm_bwd_schedule(M) for _, M, _, _ in SHAPES.values()} == {"dy_resident",
                                                                                       "dy_streamed"}


# ---------------------------------------------------------------------------
# dw's schedule on the tensor-core build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,dw", [(1, "dy_resident"), (64, "dy_resident"), (65, "dy_resident"),
                                  (320, "dy_resident"), (321, "dy_streamed"), (4096, "dy_streamed")])
def test_schedule_from_m(M, dw):
    assert gg_ops.grouped_gemm_bwd_schedule(M) == dw


@pytest.mark.parametrize("M,resident", [(320, 1), (330, 0)])
def test_launch_passes_the_schedule_to_the_c_entry(monkeypatch, M, resident):
    calls = []

    def fake(name, symbol, argtypes):
        def launch(*args):
            calls.append((name, symbol, len(argtypes), args))
            return 0
        return launch

    monkeypatch.setattr(kernels, "function", fake)
    monkeypatch.setattr(kernels, "ptr", lambda t: t)  # the fake sees the tensors themselves
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    E, K, N = 2, 136, 264
    x, w, dy = (torch.zeros(s, dtype=torch.bfloat16) for s in ((E, M, K), (E, K, N), (E, M, N)))
    before = gg_ops.grouped_gemm_bwd.launches
    dx, dw = gg_ops._launch_bwd(x, w, dy)
    [(name, symbol, nargs, args)] = calls
    assert (name, symbol, nargs, len(args)) == ("grouped_gemm", "repro_grouped_gemm_bwd_tc", 11, 11)
    assert all(a is b for a, b in zip(args[:5], (x, w, dy, dx, dw)))
    assert args[5:] == (E, M, K, N, resident, 0)
    assert (dx.shape, dw.shape) == (x.shape, w.shape)
    assert gg_ops.grouped_gemm_bwd.launches == before + 1


def test_qwen3_moe_training_shape_keeps_dy_resident():
    """The a2a body's training shape (chip_smoke's a2a_bwd_rows): C 320
    slots an expert at T 4,096 top-8 of 128, f 1,536, d 4,096."""
    from repro_torch.configs import get_config
    from repro_torch.core.control_plane import capacity_for

    cfg = get_config("qwen3-moe-235b-a22b")
    C = capacity_for(4096, cfg.num_experts, cfg.top_k, cfg.capacity_factor)
    assert (C, cfg.d_ff_expert, cfg.d_model) == (320, 1536, 4096)
    assert gg_ops.grouped_gemm_bwd_schedule(C) == "dy_resident"
    assert gg_ops.grouped_gemm_bwd_path(torch.bfloat16, cfg.d_ff_expert, cfg.d_model, True) == "tensor_cores"


def _source_constants() -> dict:
    src = (kernels.CSRC / "grouped_gemm.cu").read_text()
    body = src[src.index("namespace tcb {"):src.index("}  // namespace tcb")]
    # plain numbers and products of them ("BOX = 64 * 128")
    consts = {name: int(np.prod([int(f) for f in v.split("*")]))
              for name, v in re.findall(r"constexpr int (\w+) = ([\d\s*]+);", body)}
    dw_stages = re.search(r"STAGES = RES \? (\d+) : (\d+);", body)
    return consts | {"DW_STAGES_RESIDENT": int(dw_stages.group(1)), "DW_STAGES_STREAMED": int(dw_stages.group(2))}


def test_each_schedule_fits_the_shared_memory_budget():
    """Dynamic shared memory a block of each kernel asks for (1 KB of
    alignment slack included) fits the 227 KB (232,448 bytes) an H100 block
    may use beside its barriers, and one more resident chunk would not; the
    host's count of resident chunks is the C source's."""
    c = _source_constants()
    assert c["DW_RESIDENT_CHUNKS"] == gg_ops.BWD_RESIDENT_CHUNKS
    box, budget = c["BOX"], 232_448 - 256
    chunk = c["DW_NB"] // 64 * box
    resident = c["DW_RESIDENT_CHUNKS"] * chunk + c["DW_STAGES_RESIDENT"] * box + 1024
    streamed = c["DW_STAGES_STREAMED"] * (box + chunk) + 1024
    dx = c["DX_STAGES"] * (2 + -(-c["DX_HALVES"] * c["DX_HALF"] // 64)) * box + 1024
    assert max(resident, streamed, dx) <= budget, (resident, streamed, dx)
    assert resident + chunk > budget
    # the resident slice is ceil(M / 64) chunks of 64 rows: M 320 at the budget, 321 past it
    assert -(-320 // 64) <= c["DW_RESIDENT_CHUNKS"] < -(-321 // 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(1536, 4096), (136, 264), (20, 40), (1536, 4092)])
def test_build_choice_is_unchanged(dtype, K, N):
    want = "tensor_cores" if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 else "cuda_cores"
    assert gg_ops.grouped_gemm_bwd_path(dtype, K, N, True) == want
    assert gg_ops.grouped_gemm_bwd_path(dtype, K, N, False) == "cuda_cores"
