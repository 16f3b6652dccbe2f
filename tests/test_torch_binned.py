"""The binned primary route (K9's plain version) vs the JAX package, and
the port's binned render vs its packet render.

The chain structure of the block permutation, the eligibility rules and
the plain K9 stream (``binned_closest_plain``) on the JAX package's own
tables and bins against ``binned_closest(interpret=True)``: object ids
equal, t within 1e-5 relative (sphere normals by angle).  A binned frame differs from the packet
walk's only at exact-t ties, whose winner follows the candidate order: the
reference's budget of ``test_binned`` (at most 0.2% of pixels beyond
1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.accel import bvh as jbvh
from distributionraytracer_tpu.accel import pallas_binned as jbin
from distributionraytracer_tpu.accel import pallas_packet as jpp
from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.renderer import Renderer as JaxRenderer
from distributionraytracer_tpu.integrator.render import (
    _block_perm as jax_block_perm,
    _rays_from_samples as jax_rays_from_samples,
)
from distributionraytracer_tpu.scene.builder import (
    SceneBuilder as JaxSceneBuilder,
)
from distributionraytracer_tpu_torch.accel import cuda_binned as tbin
from distributionraytracer_tpu_torch.accel import cuda_bvh as tpb
from distributionraytracer_tpu_torch.accel import cuda_packet as tpp
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    _block_perm, make_samples,
)
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene.types import (
    ACCEL_BVH, ACCEL_GRID, OBJ_SPHERE,
)

from test_torch_render import shared_samples
from test_whitted import assert_images_close
from torch_port_util import prim_scene, to_port, torch_samples
from torch_scenes import mesh_scene

torch.set_num_threads(1)


def _mesh(accel=ACCEL_BVH, res=(32, 32), n_tri=2000):
    return mesh_scene(JaxSceneBuilder, n_tri=n_tri, accel=accel, res=res)


@pytest.mark.parametrize("shape", [(64, 64, 1), (600, 800, 1), (32, 32, 2),
                                   (32, 32, 4), (48, 40, 1), (32, 32, 3),
                                   (30, 40, 1)])
def test_chain_grid_and_block_perm_match_jax(shape):
    H, W, S = shape
    assert np.array_equal(jax_block_perm(H, W, S), _block_perm(H, W, S))
    ref, got = jbin._chain_grid(H, W, S), tbin._chain_grid(H, W, S)
    assert (ref is None) == (got is None)
    if got is not None:
        assert ref[:2] == got[:2] and np.array_equal(ref[2], got[2])
        assert got[0] * got[1] * S == tbin.LANES


def test_binned_supported_matches_jax():
    mesh = _mesh()
    prim = dataclasses.replace(prim_scene(), static=dataclasses.replace(
        prim_scene().static, accel=ACCEL_BVH))
    for js in (mesh, prim):
        ps = to_port(js)
        for kw in ({}, {"motion_blur": True}, {"dof": True}):
            assert (jbin.binned_supported(js, JaxConfig(**kw))
                    == tbin.binned_supported(ps, RenderConfig(**kw)))
    assert tbin.binned_supported(to_port(mesh), RenderConfig())
    assert not tbin.binned_supported(to_port(prim), RenderConfig())  # planes


def _primary_inputs(js, S=1):
    """The JAX package's tables, bins and block-permuted primary rays."""
    st = js.static
    H, W = st.res_y, st.res_x
    gj = jpp.pack_grouped(js, jbvh.collapse_leaves(
        jbvh.thread_bvh(jbvh.build_bvh(js)), jpp.GROUPED_LEAF))
    bins = jbin.build_primary_bins(js, jbin.group_boxes(js, gj), gj, H, W, S)
    samples = shared_samples(js, S, seed=3)
    o, d, t, _ = jax_rays_from_samples(js.device_put(), JaxConfig(spp=S),
                                       samples)
    perm = jax_block_perm(H, W, S)
    o, d, t = (np.asarray(a)[perm] for a in (o, d, t))
    valid = np.random.default_rng(1).random(o.shape[0]) < 0.95
    return gj, bins, o, d, t, valid


def test_plain_binned_matches_jax_kernel():
    """Plain K9 on the JAX package's tables and bins vs its interpret-mode
    ``binned_closest``: ids equal, t within 1e-5 relative, normals within
    the JAX packet tests' tolerance; the candidate stop saves work."""
    js = _mesh()
    ps = to_port(js)
    gj, bins, o, d, t, valid = _primary_inputs(js)
    ref = jbin.binned_closest(js.device_put(), gj, jax.device_get(bins),
                              jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                              interpret=True, valid=jnp.asarray(valid))
    tabs = tpp.from_jax_grouped(gj.node_g, gj.obj_g, gj.og_base, gj.n_nodes,
                                gj.n_groups)
    pb = tbin.from_jax_primary_bins(*(np.asarray(a) for a in (
        bins.chain_start, bins.cand, bins.cand_dist)))
    T = torch.from_numpy
    stats = {}
    gt, gn, gid = tbin.binned_closest_plain(tabs, pb, T(o), T(d), T(t),
                                            T(valid), stats=stats)
    m = valid
    rid = np.asarray(ref.obj_id)
    assert 0.3 < (rid[m] >= 0).mean() < 0.99
    assert np.array_equal(rid[m], gid.numpy()[m])
    hit = m & (rid >= 0)
    np.testing.assert_allclose(gt.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5, atol=1e-5)
    # a sphere's normal (p - c) / r magnifies its cancelling quadratic's
    # last-bit differences by t / r (test_torch_accel.py::
    # assert_hits_equal): compared by angle
    sph = np.isin(rid, np.nonzero(np.array(ps.static.obj_types)
                                  == OBJ_SPHERE)[0])
    n, rn = gn.numpy(), np.asarray(ref.normal)
    np.testing.assert_allclose(n[hit & ~sph], rn[hit & ~sph], rtol=1e-3,
                               atol=1e-4)
    assert ((n * rn).sum(-1)[hit & sph] > 0.999).all()
    n_cand = int(pb.chain_start[-1])
    assert 0 < stats["groups"] < n_cand  # chains stop before their ends


def test_plain_binned_matches_packet_walk():
    """The binned winners against the grouped walk of the whole tree, on
    the port's own tables: equal but for exact ties (<= 0.2% of lanes)."""
    js = _mesh(res=(64, 32))
    ps = to_port(js)
    r = Renderer(ps, RenderConfig(spp=0), device="cpu")
    H, W = ps.static.res_y, ps.static.res_x
    bins = r._bins_for(H, W, 1)
    assert bins is not None and bins.primary.n_chains == H * W // 128
    samples = make_samples(r.scene, r.cfg, torch.Generator().manual_seed(5))
    from distributionraytracer_tpu_torch.integrator.render import (
        _rays_from_samples,
    )
    o, d, t, _ = _rays_from_samples(r.scene, r.cfg, samples)
    perm = torch.from_numpy(_block_perm(H, W, 1)).long()
    o, d, t = o[perm], d[perm], t[perm]
    _, _, bid = tbin.binned_closest_plain(r.tabs, bins.primary, o, d, t)
    walk = tpb.packet_intersectors(r.scene, r.tabs)
    h = walk.closest(o, d, t)
    assert 0.3 < float(h.hit.float().mean())
    assert float((h.obj_id != bid).float().mean()) <= 0.002


@pytest.mark.parametrize("accel", [ACCEL_BVH, ACCEL_GRID],
                         ids=["bvh", "grid"])
def test_binned_render_matches_packet_render(accel):
    """The port's binned frame vs the same Renderer with the binned route
    switched off, on one SampleSet (the reference's budget)."""
    js = _mesh(accel=accel)
    ps = to_port(js)
    r = Renderer(ps, RenderConfig(spp=0), device="cpu")
    label = r.executed_backend()
    assert label.startswith("binned-primary+")
    samples = torch_samples(shared_samples(js, 1, seed=8))
    img_b = r.render_with_samples(samples).numpy()
    r._gbox = None  # the packet route only
    assert not r.executed_backend().startswith("binned")
    img_p = r.render_with_samples(samples).numpy()
    assert img_b.std() > 0.05
    diff = np.abs(img_b - img_p).max(axis=-1)
    assert (diff > 1e-5).sum() <= img_b.shape[0] * img_b.shape[1] * 0.002


def test_frames_the_bins_do_not_tile_take_the_packet_route():
    """Odd sample counts (S = 3) and frames whose chains do not tile the
    image build no bins: the same scene then renders on the packet route,
    and executed_backend() says so."""
    js = _mesh(res=(30, 40))
    r = Renderer(to_port(js), RenderConfig(spp=0), device="cpu")
    assert r._bins_for(40, 30, 1) is None and r._bins_for(32, 32, 3) is None
    assert r.executed_backend() == "grouped-packet"
    r2 = Renderer(to_port(_mesh()), RenderConfig(spp=0), device="cpu")
    assert r2._bins_for(32, 32, 3) is None
    assert r2.executed_backend() == "binned-primary+grouped-packet"
    assert r2.executed_backend() == "binned-primary+grouped-packet"
    assert len(r2._primary_cache) == 1  # one camera's bins, cached


def test_grid_renderer_matches_jax():
    """The port's Renderer on a grid scene (the binned route over the grid
    emulation: plain K9, then the plain K7 walk in grid shadow mode with
    the slab gates) vs the JAX Renderer's 3D-DDA (``accel_backend='xla'``)
    on one SampleSet, within ``assert_images_close``'s budget; 605
    objects, so the cost-brute route is switched off in both."""
    js = _mesh(accel=ACCEL_GRID, res=(16, 16), n_tri=600)
    samples = shared_samples(js, 1, seed=6)
    jr = JaxRenderer(js, JaxConfig(spp=0, accel_backend="xla",
                                   accel_cost_threshold=0))
    ref, ref_rays = jr.render_with_samples(samples, return_rays=True)
    ref = np.asarray(ref)
    assert ref.std() > 0.05
    r = Renderer(to_port(js), RenderConfig(spp=0, accel_cost_threshold=0),
                 device="cpu")
    assert r.executed_backend() == "binned-primary+grid-packet"
    img, nrays = r.render_with_samples(torch_samples(samples),
                                       return_rays=True)
    assert_images_close(img.numpy(), ref)
    assert abs(int(nrays) - int(ref_rays)) <= 1e-3 * int(nrays)
