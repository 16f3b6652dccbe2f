"""The path tracer's live paths over the paths its bounce loop launches,
summed over a frame's tiles and bounces: the program's ``pt.paths_live``
(each bounce's paths still alive at its start, counted on the device)
over ``pt.paths`` (a tile's paths at each bounce)."""

from portbench import program_trace

UNIT = "fraction"


def read(obs):
    prog = program_trace.read(obs, "frame")
    if prog is None or not prog["counts"].get("pt.paths"):
        return None
    c = prog["counts"]
    return c.get("pt.paths_live", 0.0) / c["pt.paths"]
