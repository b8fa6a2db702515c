"""Share of a forward of SAM's ViT image encoder in which the card runs
nothing: 1 − the profiled device time per forward over the host-clock
time per forward of an unprofiled stretch just before, %."""


def read(view):
    return view.idle_share()
