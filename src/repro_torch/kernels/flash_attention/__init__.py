"""Flash attention: vector-, page- and window-steered decode and blocked
prefill (port of ``repro/kernels/flash_attention``)."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
    flash_decode,
    flash_decode_paged,
    flash_decode_window,
)
