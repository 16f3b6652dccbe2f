"""Host milliseconds a frame inside the program's ``pt.bounce`` spans (a
bounce's uniforms sliced and packed, and its K6 launch, or the staged
body's queries and shading), from the program-traced stretch's run with
the recorder on and no profiler."""

from portbench import program_trace

UNIT = "ms"


def read(obs):
    prog = program_trace.read(obs, "frame")
    return None if prog is None else prog["span_ms"].get("pt.bounce")
