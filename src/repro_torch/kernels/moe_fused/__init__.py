"""Fused prefill MoE data plane (port of ``repro/kernels/moe_fused``)."""
from repro_torch.kernels.moe_fused.ops import fused_experts_fn, fused_moe_apply, fused_moe_fn  # noqa: F401
