"""Seconds of the ``Renderer``'s construction for an accelerated scene
(the host's BVH or grid build and packing, the tables moved to the
device), a span around it in set-up."""

UNIT = "s"


def read(obs):
    if obs.get("accel") in (None, "none"):
        return None
    spans = obs.get("spans", {}).get("accel_build")
    return spans[0] if spans else None
