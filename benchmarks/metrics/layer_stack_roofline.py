"""Share of its roofline that a step's four ``layer_stack`` calls reach:
the least time the work needs on the card (the larger of its operations
over the peak rate and its bytes over the peak bandwidth, counted from
the model's shapes in ``benchmarks/counts/newfluidnet.py``) over their
device time per step (the operations launched inside the benchmark's
spans around ``fast_path.layer_stack`` and ``layer_stacks``), %."""

from benchmarks.counts import newfluidnet


def read(view):
    g = view.config["grid"]
    flops, nbytes = newfluidnet.layer_stack(view.dims, g["H"], g["W"])
    return view.roofline("bench.layer_stack", flops, nbytes)
