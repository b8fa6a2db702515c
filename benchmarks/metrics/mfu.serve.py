"""The whole Transolver forward's share of the card's peak rate: its
operations (``benchmarks/counts/transolver.py``) over the host-clock
time of a forward in an unprofiled stretch just before the profiled
one, %."""

from benchmarks.counts import transolver


def read(view):
    return view.mfu(transolver.forward_flops(view.dims))
