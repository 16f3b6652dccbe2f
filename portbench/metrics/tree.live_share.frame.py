"""The tree loop's live lanes over the lanes it launches, summed over a
frame's levels: the program's ``whitted.lanes_live`` (each level's valid
lanes, counted on the device) over ``whitted.lanes`` (R * n a level)."""

from portbench import program_trace

UNIT = "fraction"


def read(obs):
    prog = program_trace.read(obs, "frame")
    if prog is None or not prog["counts"].get("whitted.lanes"):
        return None
    c = prog["counts"]
    return c.get("whitted.lanes_live", 0.0) / c["whitted.lanes"]
