"""The whole ViT forward's share of the card's peak rate: its operations
(``benchmarks/counts/vit.py``) over the host-clock time of a forward in
an unprofiled stretch just before the profiled one, %."""

from benchmarks.counts import vit


def read(view):
    return view.mfu(vit.forward_flops(view.dims))
