"""The whole coupled step's share of the card's peak rate: the
NewFluidNet forward's operations per step (``benchmarks/counts/
newfluidnet.py``) over the host-clock time of a step in an unprofiled
stretch just before the profiled one, %. Bounds what any kernel's
roofline can claim for ``sim_steps_per_s``."""

from benchmarks.counts import newfluidnet


def read(view):
    g = view.config["grid"]
    return view.mfu(newfluidnet.forward_flops(view.dims, g["H"], g["W"]))
