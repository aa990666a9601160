"""RecurrentGemma-2B (Griffin) (copy of ``repro/configs/recurrentgemma_2b.py``).

Hybrid RG-LRU + local attention with 1:2 attn:recurrent pattern: 26L,
d_model=2560, 10 heads (MQA, kv=1), d_ff=7680, vocab=256000,
lru_width=2560, local attention window 2048, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register, shrink

FULL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    attention_kind="local",
    local_window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    conv1d_width=4,
    tie_embeddings=True,
)

register(FULL, shrink(FULL, num_layers=3))
