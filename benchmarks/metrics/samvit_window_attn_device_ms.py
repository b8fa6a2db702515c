"""Device milliseconds per forward of SAM's window attention cores (the
scores, scale, relative-position bias, softmax and product with v of
every window block, over all its windows): the operations launched
inside the program's span ``pmc.samvit.attn.window``."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.device_ms(view, "pmc.samvit.attn.window")
