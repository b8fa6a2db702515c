"""Device milliseconds per forward of the two slice-attention kernels,
``slice_pool`` and ``slice_deslice`` (every block): the operations
launched inside the benchmark's spans around the two wrappers."""


def read(view):
    a = view.per_unit_ms("bench.slice_pool")
    b = view.per_unit_ms("bench.slice_deslice")
    return None if a is None or b is None else a + b
