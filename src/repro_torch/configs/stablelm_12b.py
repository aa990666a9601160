"""StableLM-2-12B (copy of ``repro/configs/stablelm_12b.py``).

Dense GQA decoder: 40L, d_model=5120, 32 heads (kv=8, head_dim=160),
d_ff=13824, vocab=100352.
"""
from repro_torch.configs.base import ModelConfig, register, shrink

FULL = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13_824,
    vocab_size=100_352,
)

register(FULL, shrink(FULL, num_kv_heads=2))
