"""Host time to enqueue one coupled step (``SimEngine.multi_step``): the
median over 2-step runs that start on an idle device, short enough that
the launch queue never fills. Moves ``sim_steps_per_s`` where the host
is the bottleneck."""


def read(view):
    return view.counters.get("host_enqueue_ms")
