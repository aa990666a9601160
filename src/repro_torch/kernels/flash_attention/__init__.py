"""Flash attention: vector-, page- and window-steered decode, blocked
prefill (port of ``repro/kernels/flash_attention``) and the differentiable
prefill that training runs (kernel 7 and its backward)."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
    flash_attention_train,
    flash_decode,
    flash_decode_paged,
    flash_decode_window,
)
