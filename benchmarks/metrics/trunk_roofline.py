"""Share of its roofline that a step's ``trunk`` call reaches (the
coarse levels' bicubic upsampling, the concat and merge 1 with its
GroupNorm and activation): least time from the model's shapes
(``benchmarks/counts/newfluidnet.py``) over the device time per step of
the operations launched inside the benchmark's span around
``fast_path.trunk``, %."""

from benchmarks.counts import newfluidnet


def read(view):
    g = view.config["grid"]
    flops, nbytes = newfluidnet.trunk(view.dims, g["H"], g["W"])
    return view.roofline("bench.trunk", flops, nbytes)
