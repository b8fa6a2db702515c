"""Device milliseconds per forward of SAM's Dense layers: the operations
launched inside the program's spans ``pmc.samvit.qkv``,
``pmc.samvit.out`` (the heads' merge and the output projection) and
``pmc.samvit.mlp`` (Linear, GELU, Linear)."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.device_ms(view, "pmc.samvit.qkv", "pmc.samvit.out",
                                   "pmc.samvit.mlp")
