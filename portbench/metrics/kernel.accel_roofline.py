"""K9 (``binned_closest``) and K7/K8 (the packet walks): the byte floor of
the profiled frames' live rays and object rows
(``portbench.roofline.accel_bytes_s``) over the walks' summed device time,
in %.  No operation term: the tests a traversal makes depend on its tree."""

from portbench import trace

UNIT = "%"
KERNELS = ("closest_scan_kernel", "closest_items_kernel",
           "closest_finish_kernel", "grouped_closest_kernel",
           "grouped_shadow_kernel", "legacy_closest_kernel",
           "legacy_shadow_kernel")


def read(obs):
    prof, floor = obs.get("profile"), obs.get("accel_floor_s")
    if not prof or not floor:
        return None
    t = trace.device_seconds(prof, KERNELS)
    return None if not t else 100.0 * floor / t
