"""Phi-3-Vision-4.2B (copy of ``repro/configs/phi_3_vision_4_2b.py``).

Phi3-mini backbone + CLIP vision frontend: 32L, d_model=3072, 32 heads
(MHA, kv=32), d_ff=8192, vocab=32064.  The CLIP frontend is a STUB per
spec: ``input_specs`` provides precomputed patch embeddings that are
projected and prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig, register, shrink

FULL = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    frontend="vision_stub",
    frontend_dim=1024,    # CLIP-L/14 width
    frontend_tokens=256,  # patch embeddings prepended
)

register(FULL, shrink(FULL))
