"""Device milliseconds per forward of the Transolver's projection convs
(every block's ``in_project_fx`` and ``in_project_x``, cuDNN): the
operations launched inside the benchmark's span around each block's
``Attn.project``."""


def read(view):
    return view.per_unit_ms("bench.projection")
