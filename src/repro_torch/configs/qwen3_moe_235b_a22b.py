"""Qwen3-MoE-235B-A22B (copy of ``repro/configs/qwen3_moe_235b_a22b.py``).

MoE decoder: 94L, d_model=4096, 64 heads (kv=4, head_dim=128),
expert d_ff=1536, 128 experts top-8, vocab=151936, qk-norm.
"""
from repro_torch.configs.base import ModelConfig, register, shrink

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,          # dense fallback width (unused: all layers MoE)
    d_ff_expert=1536,
    vocab_size=151_936,
    qk_norm=True,
    block_pattern=("moe",),
    num_experts=128,
    top_k=8,
    route_mode="lookahead",
    optimizer="adafactor",
)

register(FULL, shrink(FULL, num_experts=8))
