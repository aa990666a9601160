"""MusicGen-Large backbone (copy of ``repro/configs/musicgen_large.py``).

Decoder-only transformer over EnCodec tokens: 48L, d_model=2048, 32 heads
(MHA, kv=32), d_ff=8192, vocab=2048.  The audio frontend (EnCodec encoder +
text conditioning) is a STUB per spec: ``input_specs`` provides precomputed
conditioning frame embeddings that are prepended to the token sequence.
"""
from repro_torch.configs.base import ModelConfig, register, shrink

FULL = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio_stub",
    frontend_dim=1024,   # T5-large conditioning width
    frontend_tokens=64,  # conditioning frames prepended
)

register(FULL, shrink(FULL))
