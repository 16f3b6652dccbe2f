"""1 - the device's busy seconds a frame over the window's seconds a
frame.  The busy seconds come from the profiled stretch after the window;
its wall time is not used, since the profiler's tracing stretches it."""

from portbench.trace import idle_share

UNIT = "fraction"


def read(obs):
    return idle_share(obs, "frame")
