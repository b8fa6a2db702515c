"""Device milliseconds per forward of SAM's global attention cores (the
scores, scale, relative-position bias, softmax and product with v of
every global block): the operations launched inside the program's span
``pmc.samvit.attn.global``."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.device_ms(view, "pmc.samvit.attn.global")
