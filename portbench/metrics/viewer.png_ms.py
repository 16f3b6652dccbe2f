"""The median over the program-traced stretch's requests of the
program's ``viewer.png`` span (``png_bytes`` of the frame)."""

from portbench import program_trace

UNIT = "ms"


def read(obs):
    prog = program_trace.read(obs, "request")
    return (None if prog is None
            else prog["span_median_ms"].get("viewer.png"))
