"""The port's plain torch traversals against the JAX package's XLA ones.

- The batched 3D-DDA (``accel/grid.py::make_grid_intersectors``) against
  JAX's on the same ``build_grid`` tables, closest and shadow, with and
  without motion blur, on ``mesh_scene`` (a grid, 2,000 triangles, the box
  ground, so that the cells are the mesh's and not the radius-1000
  sphere's) and on ``crowd_scene`` (a plane and 1,099 small spheres).
- The port's batched DDA against its per-ray DDA, and ``leap=False``
  against ``leap=True``; rays with zero direction components and rays born
  on the grid box's faces against JAX's answer; ``_pick_unroll``.
- The threaded walk of the full tree and the stack walk
  (``accel/bvh.py``) against JAX's on ``mesh_scene`` (a BVH) and
  ``prim_scene``.

Hit masks, object ids and occlusion must be equal; on triangles, planes
and boxes t within 1e-5 relative and normals within 1e-5 (:func:`assert_hits`).
Sphere hits are the exception: the port's ``hit_packed`` sums a sphere's
quadratic in the kernels' order, JAX's XLA traversals in another, and the
quadratic cancels (b^2 ~ 4ac) for small or distant spheres, so their t
agree within 5e-3 relative and their normals within a cosine of 0.999,
and where a hit is tangent the winner may flip: on at most 0.5% of the
lanes, the budget ``test_torch_accel.py`` holds the port's walk to against
the same JAX walk (on ``crowd_scene``'s 0.08-radius spheres)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.accel import bvh as jbvh
from distributionraytracer_tpu.accel import grid as jgrid
from distributionraytracer_tpu.scene.builder import (
    SceneBuilder as JaxSceneBuilder,
)
from distributionraytracer_tpu_torch.accel import bvh as tbvh
from distributionraytracer_tpu_torch.accel import grid as tgrid
from distributionraytracer_tpu_torch.scene.types import ACCEL_BVH, ACCEL_GRID

from test_torch_accel import SPHERE_BUDGET, _sphere_ids
from torch_port_util import prim_scene, to_port
from torch_scenes import accel_rays, crowd_scene, mesh_scene

torch.set_num_threads(1)

CROWD_BOX = ((-4.0, -1.0, -4.0), (4.0, 2.0, 2.0))
PRIM_BOX = ((-2.5, -1.0, -2.0), (2.0, 2.0, 2.0))
N_RAYS = 1024
T = torch.from_numpy
J = jnp.asarray


def _with_accel(scene, accel):
    return dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, accel=accel))


SCENES = {
    # name: (JAX scene, ray box)
    "mesh": (lambda a: mesh_scene(JaxSceneBuilder, n_tri=2000, accel=a,
                                  res=(16, 16), ground="box"), None),
    "crowd": (lambda a: _with_accel(crowd_scene(JaxSceneBuilder), a),
              CROWD_BOX),
    "prim": (lambda a: _with_accel(prim_scene(), a), PRIM_BOX),
}


def assert_hits(ref, got, valid, ps):
    """``ref`` a JAX HitResult, ``got`` the port's, on ``valid`` lanes (the
    module docstring's tolerances)."""
    m = np.asarray(valid)
    rid, gid = np.asarray(ref.obj_id), got.obj_id.numpy()
    sph = _sphere_ids(ps)
    flip = m & ((np.asarray(ref.hit) != got.hit.numpy()) | (rid != gid))
    assert not (flip & ~(np.isin(rid, sph) | np.isin(gid, sph))).any()
    same = m & np.asarray(ref.hit) & (rid == gid)
    on_sph = np.isin(rid, sph)
    t, rt = got.t.numpy(), np.asarray(ref.t)
    n, rn = got.normal.numpy(), np.asarray(ref.normal)
    w = same & ~on_sph
    np.testing.assert_allclose(t[w], rt[w], rtol=1e-5, atol=0)
    np.testing.assert_allclose(n[w], rn[w], rtol=0, atol=1e-5)
    w = same & on_sph
    np.testing.assert_allclose(t[w], rt[w], rtol=5e-3, atol=0)
    off = w & ((n * rn).sum(-1) <= 0.999)
    assert (flip | off).mean() <= SPHERE_BUDGET, (flip.sum(), off.sum())
    np.testing.assert_array_equal(np.asarray(ref.mat_id)[same],
                                  got.mat_id.numpy()[same])


def _rays(name, seed):
    box = SCENES[name][1]
    return (accel_rays(N_RAYS, seed) if box is None
            else accel_rays(N_RAYS, seed, box))


@pytest.fixture(scope="module")
def grids():
    """Per scene: the JAX scene, the port's, and each package's grid."""
    out = {}
    for name in ("mesh", "crowd"):
        js = SCENES[name][0](ACCEL_GRID)
        ps = to_port(js)
        out[name] = (js, ps, jgrid.build_grid(js), tgrid.build_grid(ps))
    return out


def _times(n, mb, seed=3):
    if not mb:
        return np.zeros(n, np.float32)
    return np.random.default_rng(seed).random(n).astype(np.float32)


@pytest.mark.parametrize("mb", [False, True], ids=["static", "motion"])
@pytest.mark.parametrize("name", ["mesh", "crowd"])
def test_dda_matches_jax(grids, name, mb):
    js, ps, gj, gp = grids[name]
    for a, b in zip(gj, gp):  # both packages build the same tables
        np.testing.assert_array_equal(np.asarray(a), b)
    jx = jgrid.make_grid_intersectors(js.device_put(), gj, motion_blur=mb)
    port = tgrid.make_grid_intersectors(ps, gp, motion_blur=mb)
    o, d, dist, valid = _rays(name, seed=1)
    tm = _times(o.shape[0], mb)
    ref = jx.closest(J(o), J(d), J(tm), valid=J(valid))
    got = port.closest(T(o), T(d), T(tm), valid=T(valid))
    assert 0.2 < np.asarray(ref.hit)[valid].mean() < 0.99
    assert_hits(ref, got, valid, ps)
    s1 = np.asarray(jx.shadow(J(o), J(d), J(dist), None, valid=J(valid)))
    s2 = port.shadow(T(o), T(d), T(dist), None, valid=T(valid)).numpy()
    assert 0.05 < s1[valid].mean() < 0.95
    # a dead lane is "occluded" in both (its Init_Traverse fails)
    assert s1[~valid].all() and s2[~valid].all()
    assert (s1 != s2).mean() <= SPHERE_BUDGET


@pytest.mark.parametrize("name", ["mesh", "crowd"])
def test_batched_dda_matches_scalar_and_leap(grids, name):
    """The batched DDA (K objects and M cells an iteration, the leap)
    against the per-ray state machine: every lane equal; ``leap=False``
    bit-identical to ``leap=True``."""
    _, ps, _, gp = grids[name]
    o, d, dist, _ = (T(x) for x in _rays(name, seed=2))
    tm = torch.zeros(o.shape[0])
    batched = tgrid.make_grid_intersectors(ps, gp)
    scalar = tgrid.make_grid_scalar_intersectors(ps, gp)
    no_leap = tgrid.make_grid_intersectors(ps, gp, leap=False)
    hb, hs, hn = (x.closest(o, d, tm) for x in (batched, scalar, no_leap))
    for h in (hs, hn):
        assert torch.equal(h.hit, hb.hit) and torch.equal(h.obj_id, hb.obj_id)
        assert torch.equal(h.t, hb.t) and torch.equal(h.normal, hb.normal)
    sb = batched.shadow(o, d, dist, None)
    assert torch.equal(sb, scalar.shadow(o, d, dist, None))
    assert torch.equal(sb, no_leap.shadow(o, d, dist, None))
    assert 0.2 < float(hb.hit.float().mean()) < 0.99


def _edge_rays(g):
    """Rays the slab test finds hard: axis-aligned directions with +0 and
    -0 components, origins on the grid box's faces (a zero component
    there makes ``(lo - o) / 0`` a NaN, so ``ok`` is true and the lane
    walks until the iteration cap), origins inside and outside."""
    lo, hi = (np.asarray(x, np.float64) for x in (g.bbox_min, g.bbox_max))
    rng = np.random.default_rng(4)
    axes = np.eye(3)
    o, d = [], []
    for k in range(3):
        for sgn in (1.0, -1.0):
            for _ in range(12):
                p = rng.uniform(lo, hi)
                dd = sgn * axes[k]
                dd[(k + 1) % 3] = -0.0 if rng.random() < 0.5 else 0.0
                o.append(p)
                d.append(dd)
                face = p.copy()
                face[k] = lo[k] if sgn > 0 else hi[k]  # on the entry face
                o.append(face)
                d.append(dd)
                side = p.copy()
                side[(k + 1) % 3] = lo[(k + 1) % 3]  # on a parallel face
                o.append(side)
                d.append(dd)
                out = p.copy()
                out[k] = (lo[k] - 1.0) if sgn > 0 else (hi[k] + 1.0)
                o.append(out)  # towards the box
                d.append(dd)
                o.append(out)  # away from it: Init_Traverse fails
                d.append(-dd)
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    return o, d, np.full(o.shape[0], 2.0, np.float32)


@pytest.mark.parametrize("name", ["mesh", "crowd"])
def test_edge_rays_end_with_jax_answer(grids, name):
    js, ps, gj, gp = grids[name]
    o, d, dist = _edge_rays(gj)
    tm = np.zeros(o.shape[0], np.float32)
    jx = jgrid.make_grid_intersectors(js.device_put(), gj)
    ref = jx.closest(J(o), J(d), J(tm))
    occ_ref = np.asarray(jx.shadow(J(o), J(d), J(dist), None))
    # NaN-born walks really occur, and the port stops where JAX stops
    ok, *_ = tgrid.grid_slab(gp.bbox_min, gp.bbox_max, T(o), T(d))
    assert bool(ok.any()) and bool((~ok).any())
    for port in (tgrid.make_grid_intersectors(ps, gp),
                 tgrid.make_grid_scalar_intersectors(ps, gp)):
        got = port.closest(T(o), T(d), T(tm))
        assert_hits(ref, got, np.ones(o.shape[0], bool), ps)
        np.testing.assert_array_equal(
            port.shadow(T(o), T(d), T(dist), None).numpy(), occ_ref)


def test_pick_unroll_matches_jax(grids):
    for name, (js, ps, gj, gp) in grids.items():
        assert tgrid._pick_unroll(gp.cell_start) == jgrid._pick_unroll(
            gj.cell_start), name
    for cs in ([0, 0, 0], [0, 5, 5, 9], np.arange(0, 300, 7)):
        cs = np.asarray(cs, np.int32)
        assert tgrid._pick_unroll(cs) == jgrid._pick_unroll(cs)
        assert tgrid._pick_unroll(torch.from_numpy(cs)) == \
            jgrid._pick_unroll(cs)


@pytest.mark.parametrize("walk", ["threaded", "stack"])
@pytest.mark.parametrize("name", ["mesh", "prim"])
def test_bvh_walks_match_jax(name, walk):
    """``make_threaded_intersectors`` (the full tree, no leaf collapse) and
    ``make_bvh_intersectors`` against JAX's on each package's own build of
    the same tree.  The stack walk answers every lane (it ignores
    ``valid``, as JAX's does)."""
    js = SCENES[name][0](ACCEL_BVH)
    ps = to_port(js)
    bj, bp = jbvh.build_bvh(js), tbvh.build_bvh(ps)
    if walk == "threaded":
        jx = jbvh.make_threaded_intersectors(js.device_put(),
                                             jbvh.thread_bvh(bj))
        port = tbvh.make_threaded_intersectors(ps, tbvh.thread_bvh(bp))
    else:
        jx = jbvh.make_bvh_intersectors(js.device_put(), bj)
        port = tbvh.make_bvh_intersectors(ps, bp)
    o, d, dist, valid = _rays(name, seed=5)
    if walk == "stack":
        valid = np.ones_like(valid)
    tm = np.zeros(o.shape[0], np.float32)
    ref = jx.closest(J(o), J(d), J(tm), valid=J(valid))
    got = port.closest(T(o), T(d), T(tm), valid=T(valid))
    assert 0.3 < np.asarray(ref.hit)[valid].mean() < 0.99
    assert_hits(ref, got, valid, ps)
    s1 = np.asarray(jx.shadow(J(o), J(d), J(dist), None, valid=J(valid)))
    s2 = port.shadow(T(o), T(d), T(dist), None, valid=T(valid)).numpy()
    assert 0.05 < s1[valid].mean() < 0.95
    assert (s1 != s2)[valid].mean() <= SPHERE_BUDGET
