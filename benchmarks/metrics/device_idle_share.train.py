"""Share of a train step in which the card runs nothing: 1 − the
profiled device time per step over the host-clock time per step of an
unprofiled stretch just before, %."""


def read(view):
    return view.idle_share()
