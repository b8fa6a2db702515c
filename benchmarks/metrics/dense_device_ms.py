"""Device milliseconds per forward of the Transolver's Dense layers
outside the slice attention: the operations launched inside the
program's spans ``pmc.transolver.mlp`` (the preprocess MLP, every
block's MLP and the last block's ``mlp2``) and ``pmc.attn.out`` (every
Physics-Attention's output Dense)."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.device_ms(view, "pmc.transolver.mlp",
                                   "pmc.attn.out")
