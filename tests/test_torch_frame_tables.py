"""The frame tables a Renderer keeps across its grid and BVH frames
(``Renderer._tables_for``): on the CPU, frames of one Renderer whose
camera orbits equal a fresh Renderer's at each camera, bit for bit, and
build the camera-independent tables (the pixel-block order, the chain
grid, the material column) only on the first frame, on a new frame shape
and after an edit of a non-camera leaf, while the primary bins are built
for every new camera."""

import dataclasses
import math

import pytest
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import make_samples
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.utils import spans

from test_torch_render import ROUTE_SCENES
from torch_port_util import to_port

torch.set_num_threads(1)

KEPT = ("tables.builds.block_perm", "tables.builds.chain_grid",
        "tables.builds.packed_objects", "tables.builds.frame_tables")


def orbit(scene, deg):
    """``scene`` with its eye turned ``deg`` degrees about the up axis
    through the look-at point (Rodrigues' rotation, float64)."""
    eye, at = scene.cam_eye.double(), scene.cam_at.double()
    k = scene.cam_up.double() / torch.linalg.norm(scene.cam_up.double())
    v, a = eye - at, math.radians(deg)
    v = (v * math.cos(a) + torch.linalg.cross(k, v) * math.sin(a)
         + k * (k @ v) * (1.0 - math.cos(a)))
    return dataclasses.replace(scene, cam_eye=(at + v).float())


def counted(r, samples):
    """(image, {counter: count}) of one frame of ``samples``."""
    spans.collect()
    spans.enable()
    try:
        img = r.render_with_samples(samples)
    finally:
        spans.disable()
    out = {}
    for c in spans.collect()["counts"]:
        out[c["name"]] = out.get(c["name"], 0) + c["n"]
    return img, out


@pytest.fixture(params=["bvh", "grid"])
def kept(request):
    """(renderer, its samples, the case's label) before any frame."""
    make, over, label = ROUTE_SCENES[request.param]
    cfg = RenderConfig(**dict(over, spp=0))
    r = Renderer(to_port(make()), cfg, device="cpu")
    return r, make_samples(r.scene, cfg, torch.Generator().manual_seed(5)), \
        label


def fresh(scene, cfg, samples):
    return Renderer(scene, cfg, device="cpu").render_with_samples(samples)


def test_orbiting_frames_keep_the_tables_and_equal_fresh_renders(kept):
    """Three frames 3 degrees apart through one Renderer equal a fresh
    Renderer's frame at each camera bit for bit; frames 2 and 3 build none
    of the kept tables and one set of primary bins each."""
    r, samples, label = kept
    base, images = r.scene, []
    for i in range(3):
        r.scene = orbit(base, 3.0 * i)
        img, c = counted(r, samples)
        images.append(img)
        assert torch.equal(img, fresh(r.scene, r.cfg, samples))
        assert c["bins.primary_builds"] == 1
        if i:
            assert not any(c.get(k, 0) for k in KEPT), c
        else:
            assert all(c[k] == 1 for k in KEPT), c
    assert not torch.equal(images[0], images[2])  # the camera moved
    assert r.executed_backend() == label  # the binned route


def test_a_leaf_edit_rebuilds_the_tables_once(kept):
    """An in-place edit of the triangles' materials rebuilds the kept
    tables once, and the frame then equals a fresh Renderer's."""
    r, samples, _ = kept
    before = r.render_with_samples(samples)
    n_mat = r.scene.static.n_materials
    with torch.no_grad():
        r.scene.tri_mat[::2] = (r.scene.tri_mat[::2] + 1) % n_mat
    img, c = counted(r, samples)
    assert all(c[k] == 1 for k in KEPT), c
    assert "bins.primary_builds" not in c  # the same camera's bins
    assert not torch.equal(img, before)
    assert torch.equal(img, fresh(r.scene, r.cfg, samples))
    _, c = counted(r, samples)
    assert not any(c.get(k, 0) for k in KEPT), c


def test_a_new_frame_shape_rebuilds_the_order_and_chain_grid(kept):
    """A frame of half the rows builds the block order and chain grid of
    its own shape, and equals a fresh Renderer's frame of it."""
    r, samples, _ = kept
    r.render_with_samples(samples)
    half = make_samples(r.scene, r.cfg, torch.Generator().manual_seed(6),
                        rows=samples.time.shape[0] // 2)
    img, c = counted(r, half)
    for k in ("tables.builds.block_perm", "tables.builds.chain_grid",
              "tables.builds.frame_tables"):
        assert c[k] == 1, c
    assert img.shape[0] == half.time.shape[0]
    assert torch.equal(img, fresh(r.scene, r.cfg, half))
