"""Vector-steered flash-decode (port of ``repro/kernels/flash_attention/decode.py``)."""
from repro_torch.kernels.flash_attention.ops import flash_decode  # noqa: F401
