"""PT iterations per Stokes solve: the program's counter
``StokesFn.n_done``, read once per snapshot interval of the profiled
stretch and averaged."""


def read(view):
    return view.counters.get("pt_iterations_per_step")
