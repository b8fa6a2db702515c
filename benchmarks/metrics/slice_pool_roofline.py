"""Share of its roofline that ``slice_pool`` reaches: least time from
the model's shapes (``benchmarks/counts/transolver.py``: every point's
slice weights and the weighted sums of its features) over the device
time of the operations launched inside the benchmark's span around it,
per call, %."""

from benchmarks.counts import transolver


def read(view):
    flops, nbytes = transolver.slice_pool(view.dims)
    calls = view.trace.span_count("bench.slice_pool") / view.units
    return view.roofline("bench.slice_pool", calls * flops, calls * nbytes)
