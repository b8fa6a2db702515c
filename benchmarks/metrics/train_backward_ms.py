"""Milliseconds of a train step's backward (autograd through the module
path), between CUDA events recorded around ``loss.backward()``, averaged
over the traced run's phase steps."""


def read(view):
    return view.counters.get("backward_ms")
