"""The whole train step's share of the card's peak rate: the forward's
operations and a backward of twice as many, per sample, times the batch
(``benchmarks/counts/newfluidnet.py``), over the host-clock time of a
step in an unprofiled stretch just before the profiled one, %."""

from benchmarks.counts import newfluidnet


def read(view):
    g = view.config["grid"]
    return view.mfu(newfluidnet.train_step_flops(
        view.dims, g["H"], g["W"], view.counters["batch"]))
