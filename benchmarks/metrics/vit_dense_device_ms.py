"""Device milliseconds per forward of the ViT's Dense layers: the
operations launched inside the program's spans ``pmc.vit.qkv``,
``pmc.vit.attn.out`` (the heads' merge and the output projection),
``pmc.vit.mlp`` (Dense, GELU, Dense) and ``pmc.vit.head``."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.device_ms(view, "pmc.vit.qkv", "pmc.vit.attn.out",
                                   "pmc.vit.mlp", "pmc.vit.head")
