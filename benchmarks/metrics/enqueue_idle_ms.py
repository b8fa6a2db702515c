"""Device-idle milliseconds per step while the host was inside the
program's span ``pmc.engine.step``: each gap between device operations
of the traced stretch counts for the part of it inside a step's span,
so a gap that runs from one step into the next is split between them."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.idle_ms(view, "pmc.engine.step")
