"""Host milliseconds a frame inside the program's ``whitted.level`` spans
(the tree loop's levels, K3 or the staged intersectors included), from the
program-traced stretch's run with the recorder on and no profiler."""

from portbench import program_trace

UNIT = "ms"


def read(obs):
    prog = program_trace.read(obs, "frame")
    return None if prog is None else prog["span_ms"].get("whitted.level")
