"""Qwen3-32B (copy of ``repro/configs/qwen3_32b.py``).

Dense GQA decoder with qk-norm: 64L, d_model=5120, 64 heads (kv=8,
head_dim=128), d_ff=25600, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register, shrink

FULL = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

register(FULL, shrink(FULL, num_kv_heads=2, qk_norm=True))
