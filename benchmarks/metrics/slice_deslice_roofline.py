"""Share of its roofline that ``slice_deslice`` reaches: least time from
the model's shapes (``benchmarks/counts/transolver.py``: every point's
slice weights again and its mix of the attended tokens) over the device
time of the operations launched inside the benchmark's span around it,
per call, %."""

from benchmarks.counts import transolver


def read(view):
    flops, nbytes = transolver.slice_deslice(view.dims)
    calls = view.trace.span_count("bench.slice_deslice") / view.units
    return view.roofline("bench.slice_deslice", calls * flops,
                         calls * nbytes)
