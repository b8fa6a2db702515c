"""Device launches of the PT solve per iteration: the operations
launched inside the benchmark's span around the engine's ``stokes_fn``
call, per step, over the PT iterations per step."""


def read(view):
    ops = view.trace.span_ops("bench.pt_solve")
    iters = view.counters.get("pt_iterations_per_step")
    if not ops or not iters:
        return None
    return len(ops) / view.units / iters
