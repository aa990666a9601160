"""Architecture configs of the port; importing this package registers them."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    get_smoke_config,
    list_archs,
    register,
    shrink,
)
from repro_torch.configs import mamba2_2_7b, qwen3_moe_235b_a22b, recurrentgemma_2b  # noqa: F401
