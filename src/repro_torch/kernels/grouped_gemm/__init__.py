"""Grouped GEMM over expert slots (port of ``repro/kernels/grouped_gemm``)."""
from repro_torch.kernels.grouped_gemm.ops import (  # noqa: F401
    experts_fn, grouped_gemm, grouped_gemm_bwd, grouped_swiglu)
