"""The plain versions of K7, K8 and K3's grid mode vs the JAX package.

- The plain threaded walk (``accel/bvh.py::threaded_walk``) on the port's
  own K7 and K8 tables against the JAX package's XLA threaded walk
  (``make_threaded_intersectors``, the same function on the uncollapsed
  tree), and once each against the JAX interpret-mode kernels on the JAX
  package's own tables: hit masks and object ids equal, t within 1e-5
  relative and normals within the JAX packet tests' tolerance, occlusion
  equal.  The exception is the sphere test, whose quadratic cancels (b^2 ~
  4ac keeps a few bits for small distant spheres and the 1000-radius
  ground): against the XLA walk, which sums in another order, tangent
  sphere hits may flip on 0.5% of the lanes (:func:`assert_hits_equal`).
- The grid emulation (``accel/cuda_grid.py``) against the JAX package's
  emulation in interpret mode and against its 3D-DDA, with the reference's
  budgets (< 2% of object ids, test_pallas_packet / test_pallas_accel).
- K3's grid mode, plain, against ``fused_level(..., grid_bbox=)`` in
  interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.accel import bvh as jbvh
from distributionraytracer_tpu.accel import grid as jgrid
from distributionraytracer_tpu.accel import pallas_bvh as jpb
from distributionraytracer_tpu.accel import pallas_grid as jpg
from distributionraytracer_tpu.accel import pallas_packet as jpp
from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.ops import pallas_whitted as PW
from distributionraytracer_tpu.scene.builder import (
    SceneBuilder as JaxSceneBuilder,
)
from distributionraytracer_tpu_torch.accel import bvh as tbvh
from distributionraytracer_tpu_torch.accel import cuda_bvh as tpb
from distributionraytracer_tpu_torch.accel import cuda_grid as tpg
from distributionraytracer_tpu_torch.accel import cuda_packet as tpp
from distributionraytracer_tpu_torch.accel import grid as tgrid
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
from distributionraytracer_tpu_torch.scene.types import (
    ACCEL_BVH, ACCEL_GRID, OBJ_SPHERE,
)

from torch_port_util import to_port
from torch_scenes import (
    accel_rays, compare_levels, crowd_scene, level_inputs, mesh_scene,
)

torch.set_num_threads(1)

CROWD_BOX = ((-4.0, -1.0, -4.0), (4.0, 2.0, 2.0))
BIG_RADIUS = 100.0  # spheres whose quadratic cancels (the ground)
# lanes whose sphere winner may flip against the JAX XLA walk (tangent hits)
SPHERE_BUDGET = 0.005


def _mesh(accel=ACCEL_BVH, n_tri=2000):
    return mesh_scene(JaxSceneBuilder, n_tri=n_tri, accel=accel,
                      res=(32, 32))


def _crowd():
    s = crowd_scene(JaxSceneBuilder)
    return dataclasses.replace(s, static=dataclasses.replace(
        s.static, accel=ACCEL_BVH))


SCENES = {"mesh": (_mesh, None), "crowd": (_crowd, CROWD_BOX)}
_CACHE = {}


def _scene(name):
    if name not in _CACHE:
        js = SCENES[name][0]()
        _CACHE[name] = (js, to_port(js))
    return _CACHE[name]


def _rays(name, n, seed):
    box = SCENES[name][1]
    return accel_rays(n, seed) if box is None else accel_rays(n, seed, box)


def _port_tables(ps, kind, motion_blur=False):
    tb = tbvh.thread_bvh(tbvh.build_bvh(ps))
    prot = tbvh.protect_mask(ps, motion_blur)
    if kind == "grouped":
        return tpp.pack_grouped(ps, tbvh.collapse_leaves(
            tb, tpp.GROUPED_LEAF, protect=prot))
    return tpb.pack_threaded(ps, tbvh.collapse_leaves(
        tb, tpb.PACKET_LEAF, protect=prot))


def _sphere_ids(ps, min_radius=0.0):
    st = ps.static
    r = ps.sph_radius.numpy()
    return np.array([gid for gid, (t, k) in enumerate(zip(st.obj_types,
                                                         st.obj_tidx))
                     if t == OBJ_SPHERE and r[k] >= min_radius], np.int64)


def assert_hits_equal(ref, got, valid, ps, id_budget=0.0,
                      sphere_budget=0.0):
    """``ref`` a JAX HitResult, ``got`` the port's, on valid lanes: hit
    masks and object ids equal but for ``id_budget`` of the lanes, and for
    ``sphere_budget`` more whose winner in either is a sphere; t and
    normals where both hit the same object.

    The sphere quadratic is ill-conditioned (b^2 ~ 4ac for small distant
    spheres and for the 1000-radius ground), so where the JAX package sums
    its dot products in another order (its XLA walk) the two disagree at
    tangent hits, on t (5e-3 relative; 1.3e-3 seen) and on the normal ((p - c) / r
    magnifies t's error by t / r, up to 250 here: the normals' cosine above
    0.999).  Everywhere else, and against the
    JAX kernels (whose order the port keeps), t agrees within 1e-5
    relative and normals within the JAX packet tests' tolerance."""
    m = np.asarray(valid)
    rid, gid = np.asarray(ref.obj_id), got.obj_id.numpy()
    sph = _sphere_ids(ps)
    flip = m & ((np.asarray(ref.hit) != got.hit.numpy()) | (rid != gid))
    on_sph = np.isin(rid, sph) | np.isin(gid, sph)
    assert (flip & ~on_sph).mean() <= id_budget
    assert (flip & on_sph).mean() <= id_budget + sphere_budget
    same = m & np.asarray(ref.hit) & (rid == gid)
    ill = np.isin(rid, sph) if sphere_budget else np.isin(
        rid, _sphere_ids(ps, BIG_RADIUS))
    t, rt = got.t.numpy(), np.asarray(ref.t)
    n, rn = got.normal.numpy(), np.asarray(ref.normal)
    w = same & ~ill
    np.testing.assert_allclose(t[w], rt[w], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n[w], rn[w], rtol=1e-3, atol=1e-4)
    w = same & ill
    np.testing.assert_allclose(t[w], rt[w], rtol=5e-3, atol=1e-5)
    assert ((n[w] * rn[w]).sum(-1) > 0.999).all()
    assert np.array_equal(np.asarray(ref.mat_id)[same],
                          got.mat_id.numpy()[same])


@pytest.mark.parametrize("kind", ["grouped", "threaded"], ids=["K7", "K8"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_walk_matches_jax_threaded(name, kind):
    """The plain version of K7/K8 on its own tables vs the JAX package's
    XLA threaded walk of the uncollapsed tree (the reference's walk)."""
    js, ps = _scene(name)
    tabs = _port_tables(ps, kind)
    assert tabs is not None and tabs.kind == kind
    xla = jbvh.make_threaded_intersectors(js.device_put(),
                                          jbvh.thread_bvh(jbvh.build_bvh(js)))
    port = tpb.packet_intersectors(ps, tabs)
    o, d, dist, valid = _rays(name, 2048, seed=1)
    tm = np.zeros(o.shape[0], np.float32)
    T = torch.from_numpy
    ref = xla.closest(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                      valid=jnp.asarray(valid))
    got = port.closest(T(o), T(d), T(tm), valid=T(valid))
    assert 0.3 < np.asarray(ref.hit)[valid].mean() < 0.99
    assert_hits_equal(ref, got, valid, ps, sphere_budget=SPHERE_BUDGET)
    s1 = np.asarray(xla.shadow(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(dist), None,
                               valid=jnp.asarray(valid)))
    s2 = port.shadow(T(o), T(d), T(dist), None, valid=T(valid)).numpy()
    assert 0.05 < s1[valid].mean() < 0.95
    assert (s1 != s2)[valid].mean() <= SPHERE_BUDGET


def test_plain_walk_motion_blur_matches_jax():
    """Moving spheres (centre.y += time): closest hits at the rays' times,
    shadow rays at time 0; the protect mask keeps the spheres out of the
    collapsed leaves.  Boundary rays whose winner flips among overlapping
    moving spheres are measure-zero: the reference budgets 2% of ids."""
    js, ps = _scene("crowd")
    tabs = _port_tables(ps, "grouped", motion_blur=True)
    xla = jbvh.make_threaded_intersectors(
        js.device_put(), jbvh.thread_bvh(jbvh.build_bvh(js)),
        motion_blur=True)
    port = tpb.packet_intersectors(ps, tabs, motion_blur=True)
    o, d, dist, valid = _rays("crowd", 2048, seed=2)
    tm = np.random.default_rng(3).random(o.shape[0]).astype(np.float32)
    T = torch.from_numpy
    ref = xla.closest(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                      valid=jnp.asarray(valid))
    got = port.closest(T(o), T(d), T(tm), valid=T(valid))
    assert_hits_equal(ref, got, valid, ps, id_budget=0.02,
                      sphere_budget=SPHERE_BUDGET)
    s1 = np.asarray(xla.shadow(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(dist), None,
                               valid=jnp.asarray(valid)))
    s2 = port.shadow(T(o), T(d), T(dist), None, valid=T(valid)).numpy()
    assert (s1 != s2)[valid].mean() <= SPHERE_BUDGET


@pytest.mark.parametrize("kind", ["grouped", "threaded"], ids=["K7", "K8"])
def test_plain_walk_matches_jax_interpret_kernel(kind):
    """Once per kernel: the JAX interpret-mode kernel on the JAX package's
    tables vs the port's plain walk on the same tables converted
    (``from_jax_grouped`` / ``from_jax_threaded``)."""
    js, ps = _scene("mesh")
    tj = jbvh.thread_bvh(jbvh.build_bvh(js))
    if kind == "grouped":
        cj = jbvh.collapse_leaves(tj, jpp.GROUPED_LEAF)
        jt = jpp.pack_grouped(js, cj)
        kern = jpp.make_grouped_intersectors(js.device_put(), jt,
                                             interpret=True)
        tabs = tpp.from_jax_grouped(jt.node_g, jt.obj_g, jt.og_base,
                                    jt.n_nodes, jt.n_groups)
    else:
        cj = jbvh.collapse_leaves(tj, jpb.PACKET_LEAF)
        kern = jpb.make_pallas_bvh_intersectors(
            js.device_put(), jpb.pack_threaded(js, cj), interpret=True)
        tabs = tpb.from_jax_threaded(ps, cj.node_box, cj.node_meta,
                                     cj.obj_order)
    o, d, dist, valid = _rays("mesh", 256, seed=4)
    tm = np.zeros(o.shape[0], np.float32)
    T = torch.from_numpy
    port = tpb.packet_intersectors(ps, tabs)
    ref = kern.closest(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                       valid=jnp.asarray(valid))
    assert_hits_equal(ref, port.closest(T(o), T(d), T(tm), valid=T(valid)),
                      valid, ps)
    for mode in ("bvh", "grid") if kind == "grouped" else ("bvh",):
        if mode == "grid":
            kern = jpp.make_grouped_intersectors(js.device_put(), jt,
                                                 interpret=True,
                                                 shadow_mode="grid")
            port = tpb.packet_intersectors(ps, tabs, shadow_mode="grid")
        s1 = np.asarray(kern.shadow(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(dist), None,
                                    valid=jnp.asarray(valid)))
        s2 = port.shadow(T(o), T(d), T(dist), None, valid=T(valid)).numpy()
        assert np.array_equal(s1[valid], s2[valid]), mode


def _grid_pair(n_tri=2000):
    js = _mesh(ACCEL_GRID, n_tri)
    ps = to_port(js)
    gj = jgrid.build_grid(js)
    gp = tgrid.build_grid(ps)
    return js, ps, gj, jpg.pack_grid(js, gj), tpg.pack_grid(ps, gp)


def test_grid_emulation_matches_jax():
    """The port's emulation (plain walk in grid shadow mode plus the slab
    gates) against the JAX package's emulation in interpret mode (ids
    equal) and against its 3D-DDA (the reference's budgets: < 2% of ids
    and of occlusion flags)."""
    js, ps, gj, pj, pp = _grid_pair()
    port = tpg.make_cuda_grid_intersectors(ps, pp, plain=True)
    T = torch.from_numpy
    o, d, dist, valid = _rays("mesh", 256, seed=5)
    tm = np.zeros(o.shape[0], np.float32)
    kern = jpg.make_pallas_grid_intersectors(js.device_put(), pj,
                                             interpret=True)
    args = (jnp.asarray(o), jnp.asarray(d))
    ref = kern.closest(*args, jnp.asarray(tm), valid=jnp.asarray(valid))
    got = port.closest(T(o), T(d), T(tm), valid=T(valid))
    assert_hits_equal(ref, got, valid, ps)
    s1 = np.asarray(kern.shadow(*args, jnp.asarray(dist), None,
                                valid=jnp.asarray(valid)))
    s2 = port.shadow(T(o), T(d), T(dist), None, valid=T(valid)).numpy()
    assert np.array_equal(s1[valid], s2[valid])

    o, d, dist, valid = _rays("mesh", 2048, seed=6)
    tm = np.zeros(o.shape[0], np.float32)
    dda = jgrid.make_grid_intersectors(js.device_put(), gj)
    args = (jnp.asarray(o), jnp.asarray(d))
    ref = dda.closest(*args, jnp.asarray(tm), valid=jnp.asarray(valid))
    got = port.closest(T(o), T(d), T(tm), valid=T(valid))
    assert 0.3 < np.asarray(ref.hit)[valid].mean()
    assert_hits_equal(ref, got, valid, ps, id_budget=0.02,
                      sphere_budget=SPHERE_BUDGET)
    s1 = np.asarray(dda.shadow(*args, jnp.asarray(dist), None,
                               valid=jnp.asarray(valid)))
    s2 = port.shadow(T(o), T(d), T(dist), None, valid=T(valid)).numpy()
    assert (s1[valid] != s2[valid]).mean() <= 0.02


def test_fused_level_grid_mode_plain_matches_jax():
    """K3's grid mode, plain, vs the JAX package's fused level with the
    same ``grid_bbox`` in interpret mode, on a small grid scene (a spawning
    level; the leaf level runs in the render below)."""
    spawn = True
    js, ps, gj, _, _ = _grid_pair(n_tri=200)
    o, d, t, ior, ls, valid = level_inputs(512, seed=13)
    o = (o * 0.6 + np.array([0.0, 1.4, 0.0], np.float32)).astype(np.float32)
    gb = (np.asarray(gj.bbox_min), np.asarray(gj.bbox_max))
    ref = PW.fused_level(js.device_put(), JaxConfig(), o, d, t, ior, ls,
                         valid, spawn=spawn, interpret=True,
                         grid_bbox=tuple(jnp.asarray(b) for b in gb))
    tt = torch.from_numpy
    res = CW.fused_level_plain(ps, RenderConfig(), tt(o), tt(d), tt(t),
                               tt(ior), tt(ls), tt(valid), spawn=spawn,
                               grid_bbox=gb)
    hit = res["_hit"].numpy() & valid
    assert 0.1 < hit.mean() < 0.9
    # the slab gate bites: some lanes start outside the grid box
    assert (~tgrid.grid_slab(*gb, tt(o), tt(d))[0].numpy()).any()
    compare_levels(ref, res, valid)


def test_fused_grid_render_matches_jax():
    """``render_from_samples(..., fused_grid=)``: every level on K3's grid
    mode (plain on CPU tensors) vs the JAX package's fused grid levels in
    interpret mode, on one SampleSet."""
    from distributionraytracer_tpu.integrator.render import (
        render_from_samples as jax_render,
    )
    from distributionraytracer_tpu_torch.integrator.render import (
        render_from_samples,
    )

    from test_torch_render import shared_samples
    from test_whitted import assert_images_close
    from torch_port_util import torch_samples

    js = mesh_scene(JaxSceneBuilder, n_tri=200, accel=ACCEL_GRID, res=(8, 8))
    ps = to_port(js)
    gj = jgrid.build_grid(js)
    gb = (np.array(gj.bbox_min), np.array(gj.bbox_max))
    samples = shared_samples(js, 1, seed=7)
    ref, ref_rays = jax_render(js.device_put(), JaxConfig(spp=0), samples,
                               return_rays=True, fused_grid=gb)
    img, nrays = render_from_samples(ps, RenderConfig(spp=0),
                                     torch_samples(samples),
                                     return_rays=True, fused_grid=gb)
    assert np.asarray(ref).std() > 0.05
    assert_images_close(img.numpy(), np.asarray(ref))
    assert int(nrays) == int(ref_rays)
