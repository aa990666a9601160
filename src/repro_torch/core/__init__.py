"""Control words (plans), the control plane that computes them, and the
host-only Agile PE Assignment (``cdfg``, ``agile``)."""
