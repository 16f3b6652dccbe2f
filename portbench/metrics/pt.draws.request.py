"""The path tracer's generator draws a viewer request makes: the program's
``pt.draws`` counter (one a ``torch.rand`` call of the generated-uniform
route: the frame's jitter and times, and five uniforms a bounce of each
tile), from the program-traced stretch."""

from portbench import program_trace

UNIT = "calls"


def read(obs):
    prog = program_trace.read(obs, "request")
    return None if prog is None else prog["counts"].get("pt.draws")
