"""Share of the process's coupled steps that ran by replaying a captured
CUDA graph of a fused ML_STOKES chunk, %: the program's step counters
``SimEngine.graph_steps`` and ``SimEngine.eager_steps``
(``sim/engine.py::SimEngine.multi_step``), read after the traced run, so
they count set-up, the unprofiled stretch, the enqueue probe and the
profiled stretch, which runs eagerly. None where the program has no such
counters (a commit before them) or ran no step."""


def read(view):
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine

    graph = getattr(SimEngine, "graph_steps", None)
    eager = getattr(SimEngine, "eager_steps", None)
    if graph is None or eager is None or graph + eager == 0:
        return None
    return 100.0 * graph / (graph + eager)
