"""Mamba2-2.7B (SSD, state-space duality) (copy of ``repro/configs/mamba2_2_7b.py``;
arXiv:2405.21060).

Attention-free SSM: 64L, d_model=2560, expand=2 (d_inner=5120),
ssm_state=128, head_dim=64 (80 SSD heads), conv width 4, chunk 256,
vocab=50280, tied embeddings.  Its per-slot decode state (conv tail and the
(80, 128, 64) f32 SSD state per layer) does not grow with the prompt.
"""
from repro_torch.configs.base import ModelConfig, register, shrink

FULL = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,        # unused by SSD blocks
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    block_pattern=("ssm",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv1d_width=4,
    tie_embeddings=True,
)

register(FULL, shrink(FULL, num_layers=2, d_ff=0))
