"""The whole forward of SAM's ViT image encoder as a share of the card's
peak rate: the operations the real tokens need
(``benchmarks/counts/samvit.py``: the GEMMs over the 4,048 real rows,
both kinds of attention core, the embedding, the neck and the head) over
the host-clock time of a forward in an unprofiled stretch just before the
profiled one, %."""

from benchmarks.counts import samvit


def read(view):
    return view.mfu(samvit.forward_flops(view.dims))
