"""Plan-steered decode MoE (port of ``repro/kernels/moe_decode``)."""
from repro_torch.kernels.moe_decode.ops import decode_moe  # noqa: F401
