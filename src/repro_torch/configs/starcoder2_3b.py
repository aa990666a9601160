"""StarCoder2-3B (copy of ``repro/configs/starcoder2_3b.py``).

Dense GQA decoder with RoPE: 30L, d_model=3072, 24 heads (kv=2),
d_ff=12288, vocab=49152.
"""
from repro_torch.configs.base import ModelConfig, register, shrink

FULL = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12_288,
    vocab_size=49_152,
    qkv_bias=True,  # starcoder2 uses bias
    rope_theta=100_000.0,
)

register(FULL, shrink(FULL, num_kv_heads=1, qkv_bias=True))
