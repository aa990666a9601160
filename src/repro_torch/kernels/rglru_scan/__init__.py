"""RG-LRU linear recurrence (port of ``repro/kernels/rglru_scan``)."""
from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: F401
