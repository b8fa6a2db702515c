"""Device milliseconds per step of the fused executor
(``FastNewFluidNet.psi``: its ``layer_stack`` and ``trunk`` kernels),
from the profiler: every device operation launched inside the
benchmark's span around ``psi``."""


def read(view):
    return view.per_unit_ms("bench.executor")
