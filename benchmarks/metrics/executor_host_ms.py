"""Host milliseconds per step inside the program's span ``pmc.executor``
(``FastNewFluidNet.psi``: the checks and launches of its four
``layer_stack`` and one ``trunk`` calls), in the traced stretch. The
profiler lengthens host work, so this reads above an unprofiled run."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.host_ms(view, "pmc.executor")
