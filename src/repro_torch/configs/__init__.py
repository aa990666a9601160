"""Architecture configs of the port; importing this package registers them."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPE_CELLS,
    ModelConfig,
    ShapeCell,
    cells_for,
    get_config,
    get_smoke_config,
    list_archs,
    register,
    shrink,
)
from repro_torch.configs import (  # noqa: F401
    llama4_maverick_400b_a17b,
    mamba2_2_7b,
    musicgen_large,
    phi_3_vision_4_2b,
    qwen1_5_4b,
    qwen3_32b,
    qwen3_moe_235b_a22b,
    recurrentgemma_2b,
    stablelm_12b,
    starcoder2_3b,
)
