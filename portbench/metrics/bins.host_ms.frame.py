"""Host milliseconds a frame inside the program's ``render.bins`` span
(``Renderer._bins_for``: the camera key's reads, and on a new camera the
primary bins' build and copy to the card)."""

from portbench import program_trace

UNIT = "ms"


def read(obs):
    prog = program_trace.read(obs, "frame")
    return None if prog is None else prog["span_ms"].get("render.bins")
