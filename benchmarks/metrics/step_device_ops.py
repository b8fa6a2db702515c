"""Device operations (kernels, copies, memsets) that one coupled step
launches: those whose launch ran inside the program's span
``pmc.engine.step`` (``sim/engine.py::SimEngine.multi_step``: the step
and its records), per step of the traced stretch. Counted from the
device trace, not from the wrappers' call counters."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.op_count(view, "pmc.engine.step")
