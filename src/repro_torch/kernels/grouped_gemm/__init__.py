"""Grouped GEMM over expert slots (port of ``repro/kernels/grouped_gemm``)."""
from repro_torch.kernels.grouped_gemm.ops import experts_fn, grouped_gemm, grouped_swiglu  # noqa: F401
