"""Plan-steered dispatch and combine (port of ``repro/kernels/moe_dispatch``)."""
from repro_torch.kernels.moe_dispatch.ops import (  # noqa: F401
    combine, combine_bwd, combine_fn, dispatch, dispatch_bwd, dispatch_fn)
