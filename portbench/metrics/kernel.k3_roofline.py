"""K3 (``fused_level``): the frame's summed least time of the fused level
kernel (``portbench.roofline.k3_bound_s`` over the reference's ray tree of
the profiled frames) over its summed device time in the profile, in %."""

from portbench import trace

UNIT = "%"


def read(obs):
    prof, bound = obs.get("profile"), obs.get("k3_bound_s")
    if not prof or not bound:
        return None
    t = trace.device_seconds(prof, ("whitted_level_kernel",))
    return None if not t else 100.0 * bound / t
