"""Milliseconds of a train step's Adam update, between CUDA events
recorded around ``optimizer.step()``, averaged over the traced run's
phase steps."""


def read(view):
    return view.counters.get("adam_ms")
