"""Qwen1.5-4B (copy of ``repro/configs/qwen1_5_4b.py``).

Dense MHA decoder with QKV bias: 40L, d_model=2560, 20 heads (kv=20),
d_ff=6912, vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, register, shrink

FULL = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
)

register(FULL, shrink(FULL, qkv_bias=True))
