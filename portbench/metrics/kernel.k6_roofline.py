"""K6 (``pt_bounce``): the frame's summed least time of the bounce kernel
(``portbench.roofline_pt.k6_bound_s`` over the reference's live paths of
the profiled frames) over its summed device time in the profile, in %."""

from portbench import trace

UNIT = "%"


def read(obs):
    prof, bound = obs.get("profile"), obs.get("k6_bound_s")
    if not prof or not bound:
        return None
    t = trace.device_seconds(prof, ("pt_bounce_kernel",))
    return None if not t else 100.0 * bound / t
