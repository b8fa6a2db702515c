"""Device-idle milliseconds per step while the host was inside the
program's span ``pmc.engine.snapshot`` (``SimEngine.rollout``'s blocking
copies of the fields to the host), split by overlap as in
``enqueue_idle_ms``."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.idle_ms(view, "pmc.engine.snapshot")
