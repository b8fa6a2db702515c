"""Device milliseconds per forward of SAM's window partition: the pad
and partition before each window block's attention and the unpartition
and crop after it, the operations launched inside the program's span
``pmc.samvit.partition``."""

from benchmarks.harness import program_spans


def read(view):
    return program_spans.device_ms(view, "pmc.samvit.partition")
