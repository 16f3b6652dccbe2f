"""The frame plan (``Renderer._plan``, ``integrator.render._plan_frame``):
on the CPU, one small frame of every route the Renderer labels, whose plan
carries the label ``executed_backend()`` returns, and whose recorder
counts of table builds, host reads and primary-bin builds are those of a
Renderer's first frame on that route (``PARENT_COUNTS``, first recorded on
the same frames before the routing moved into the plan; a grid or BVH
frame's since count the frame tables the Renderer keeps)."""

import dataclasses

import pytest
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import make_samples
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene import (
    ACCEL_BVH, ACCEL_GRID, ACCEL_NONE, create_random_scene,
)
from distributionraytracer_tpu_torch.utils import spans

from test_torch_render import ROUTE_SCENES, _mesh
from torch_port_util import prim_scene, to_port

torch.set_num_threads(1)

TILE = 100  # several tiles a frame, where the route tiles


def _dark():
    scene = to_port(prim_scene())
    dark = dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, n_lights=0, light_quad=(), light_grid=()))
    dark.light_pos = dark.light_pos[:0]
    dark.light_e1, dark.light_e2 = dark.light_e1[:0], dark.light_e2[:0]
    return dark


# case: (port scene, config overrides, the label), besides ROUTE_SCENES
MORE_SCENES = {
    "fused-level": (lambda: create_random_scene(0, 24, 16), {"spp": 1},
                    "fused-level"),
    "brute-kernel": (_dark, {"spp": 1}, "brute-kernel"),
    "plain": (lambda: create_random_scene(0, 24, 16),
              {"spp": 1, "kernels": "off"}, "plain"),
    # small: the DDA is slow on the CPU
    "grid-dda": (lambda: to_port(_mesh(ACCEL_GRID, 200, (8, 8))),
                 {"accel_backend": "traversal"}, "grid-dda"),
    "bvh-threaded": (lambda: to_port(_mesh(ACCEL_BVH, 200, (8, 8))),
                     {"accel_backend": "traversal"}, "bvh-threaded"),
}
CASES = sorted(ROUTE_SCENES) + sorted(MORE_SCENES)

# A first frame's tables.builds.*, sync.host_reads (none: the CPU has no
# card to read) and bins.primary_builds.  Every grid or BVH frame builds
# the Renderer's frame tables once (frame_tables, and in them the pixel
# block order, block_perm), whose packet walk holds the one packed_objects
# of its material column and, on the binned route, the chain grid of that
# same order; before the tables were kept, bvh and grid counted two
# packed_objects and an uncounted second block order a frame.
PARENT_COUNTS = {
    "bvh": {"bins.primary_builds": 1, "tables.builds.block_perm": 1,
            "tables.builds.chain_grid": 1, "tables.builds.frame_tables": 1,
            "tables.builds.packed_objects": 1, "tables.builds.pixel_grid": 1},
    "cost-brute": {"tables.builds.block_perm": 1,
                   "tables.builds.frame_tables": 1,
                   "tables.builds.object_tables": 1,
                   "tables.builds.packed_objects": 1,
                   "tables.builds.pixel_grid": 1},
    "grid": {"bins.primary_builds": 1, "tables.builds.block_perm": 1,
             "tables.builds.chain_grid": 1, "tables.builds.frame_tables": 1,
             "tables.builds.packed_objects": 1, "tables.builds.pixel_grid": 1},
    "legacy": {"tables.builds.block_perm": 1,
               "tables.builds.frame_tables": 1,
               "tables.builds.packed_objects": 1,
               "tables.builds.pixel_grid": 1},
    "legacy-grid": {"tables.builds.block_perm": 1,
                    "tables.builds.frame_tables": 1,
                    "tables.builds.packed_objects": 1,
                    "tables.builds.pixel_grid": 1},
    "plane-bvh": {"tables.builds.block_perm": 1,
                  "tables.builds.frame_tables": 1,
                  "tables.builds.packed_objects": 1,
                  "tables.builds.pixel_grid": 1},
    "plane-grid": {"tables.builds.block_perm": 1,
                   "tables.builds.frame_tables": 1,
                   "tables.builds.packed_objects": 1,
                   "tables.builds.pixel_grid": 1},
    # two tiles, each building the brute scans' tables
    "brute-kernel": {"tables.builds.object_tables": 2,
                     "tables.builds.packed_objects": 2,
                     "tables.builds.pixel_grid": 1},
    "bvh-threaded": {"tables.builds.block_perm": 1,
                     "tables.builds.frame_tables": 1,
                     "tables.builds.packed_objects": 2,
                     "tables.builds.pixel_grid": 1},
    "fused-level": {"tables.builds.level_tables": 1,
                    "tables.builds.pack_whitted_mats": 1,
                    "tables.builds.packed_objects": 2,
                    "tables.builds.pixel_grid": 1},
    "grid-dda": {"tables.builds.block_perm": 1,
                 "tables.builds.frame_tables": 1,
                 "tables.builds.packed_objects": 1,
                 "tables.builds.pixel_grid": 1},
    "plain": {"tables.builds.pixel_grid": 1},
}


def frame(case):
    """(renderer, samples, label) of one case's small CPU frame."""
    if case in ROUTE_SCENES:
        make, over, label = ROUTE_SCENES[case]
        scene, over = to_port(make()), dict(over, spp=0)
    else:
        make, over, label = MORE_SCENES[case]
        scene = make()
    cfg = RenderConfig(tile_rays=TILE, **over)
    r = Renderer(scene, cfg, device="cpu")
    return r, make_samples(r.scene, cfg, torch.Generator().manual_seed(5)), \
        label


def frame_counts(r, samples):
    """The recorder's table-build, host-read and bin-build counts of one
    frame of ``samples``."""
    spans.collect()
    spans.enable()
    try:
        r.render_with_samples(samples)
    finally:
        spans.disable()
    out = {}
    for c in spans.collect()["counts"]:
        name = c["name"]
        if name.startswith("tables.builds.") or name in (
                "sync.host_reads", "bins.primary_builds"):
            out[name] = out.get(name, 0) + c["n"]
    return out


@pytest.mark.parametrize("case", CASES)
def test_frame_plan_labels_and_counts(case, monkeypatch):
    """The plan the frame ran carries the label ``executed_backend()``
    returns, and the frame made the table builds, host reads and primary
    bin builds of ``PARENT_COUNTS``."""
    r, samples, label = frame(case)
    plans, plan = [], r._plan

    def recording(s=None):
        plans.append(plan(s))
        return plans[-1]

    monkeypatch.setattr(r, "_plan", recording)
    counts = frame_counts(r, samples)
    ran = plans[0]
    assert len(plans) == 1
    assert ran.label == r.executed_backend() == label
    assert ran.mode == ("k3" if case == "fused-level" else "staged")
    assert (ran.order is not None) == (r.accel != ACCEL_NONE)
    assert (ran.bins is not None) == label.startswith("binned")
    assert counts == PARENT_COUNTS[case]
