"""Host calls a frame that put work on the device (kernel and graph
launches, asynchronous copies and memsets), from the profiler's host
events: an exact count."""

UNIT = "calls"


def read(obs):
    prof = obs.get("profile")
    if obs.get("unit") != "frame" or not prof:
        return None
    return sum(prof["launch_calls"].values()) / prof["units"]
