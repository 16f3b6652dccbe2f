"""1 - the device's busy seconds a step over the window's seconds a
step.  The busy seconds come from the profiled stretch after the window;
its wall time is not used, since the profiler's tracing stretches it."""

from portbench.trace import idle_share

UNIT = "fraction"


def read(obs):
    return idle_share(obs, "step")
