"""Data pipeline (the port of ``repro/data``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    FileTokenDataset,
    MarkovLMDataset,
    ShardedLoader,
)
