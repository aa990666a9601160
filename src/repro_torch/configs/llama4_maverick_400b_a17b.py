"""Llama-4-Maverick-400B-A17B (copy of ``repro/configs/llama4_maverick_400b_a17b.py``).

MoE decoder: 48L, d_model=5120, 40 heads (kv=8), expert d_ff=8192,
128 experts top-1 (+1 shared expert), vocab=202048.  Top-1 routing is the
purest branch-divergence form (Switch-style: exactly one taken path).
Early-fusion multimodality is out of backbone scope per spec.
"""
from repro_torch.configs.base import ModelConfig, register, shrink

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    d_ff_expert=8192,
    vocab_size=202_048,
    block_pattern=("moe",),
    num_experts=128,
    top_k=1,
    num_shared_experts=1,
    route_mode="lookahead",
    optimizer="adafactor",  # memory roofline: 400B params on 256 chips
)

register(FULL, shrink(FULL, num_experts=8))
