"""Mamba-2 chunked SSD scan (port of ``repro/kernels/ssd_scan``)."""
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: F401
