"""Device milliseconds per forward of the Transolver blocks' LayerNorms
(``ln_1``, ``ln_2`` of every block, ``ln_3`` of the last): the
operations launched inside the program's span ``pmc.transolver.norm``."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.device_ms(view, "pmc.transolver.norm")
