"""Plan-steered dispatch and combine (port of ``repro/kernels/moe_dispatch``)."""
from repro_torch.kernels.moe_dispatch.ops import combine, dispatch  # noqa: F401
