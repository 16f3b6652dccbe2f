"""Host milliseconds a frame inside the program's ``accel.grid_gate``
spans (the uniform grid's closest-hit and shadow gates, on top of every
K9 and K7 query of a grid scene), from the program-traced stretch's run
with the recorder on and no profiler."""

from portbench import program_trace

UNIT = "ms"


def read(obs):
    prog = program_trace.read(obs, "frame")
    return None if prog is None else prog["span_ms"].get("accel.grid_gate")
