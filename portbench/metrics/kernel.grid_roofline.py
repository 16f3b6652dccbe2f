"""K9 (``binned_closest``) and K7 (the packet walks, in grid shadow mode
on the grid emulation's tree) on a uniform-grid scene: the byte floor of
the profiled frames' live rays and object rows under the grid reference
(``obs["grid_floor_s"]``: ``portbench.roofline.accel_bytes_s`` of
``portbench.reference.grid``'s counts) over the walks' summed device time,
in %.  The kernels are those ``kernel.accel_roofline`` reads."""

from portbench import trace

UNIT = "%"
KERNELS = ("closest_scan_kernel", "closest_items_kernel",
           "closest_finish_kernel", "grouped_closest_kernel",
           "grouped_shadow_kernel", "legacy_closest_kernel",
           "legacy_shadow_kernel")


def read(obs):
    prof, floor = obs.get("profile"), obs.get("grid_floor_s")
    if not prof or not floor:
        return None
    t = trace.device_seconds(prof, KERNELS)
    return None if not t else 100.0 * floor / t
