"""Device milliseconds per forward of the ViT's attention core (every
block's scores, scale, softmax and weighted sum of v): the operations
launched inside the program's span ``pmc.vit.attn.core``."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.device_ms(view, "pmc.vit.attn.core")
