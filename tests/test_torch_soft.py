"""The port's discontinuity estimators against the JAX package, on the CPU:
``soft_visibility`` (soft shadows), ``primary_coverage`` and
``trace_whitted_soft`` (soft silhouettes) and their helpers on seeded rays,
values and gradients; whole renders of ``test_grad``'s shadow-edge and
sphere-edge scenes; and the port's mirrors of ``test_grad``'s
finite-difference tests, at that file's own tolerances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.integrator import whitted as jax_whitted
from distributionraytracer_tpu.integrator.render import (
    make_samples as jax_samples, render_from_samples as jax_render,
)
from distributionraytracer_tpu.ops import intersect as jax_intersect
from distributionraytracer_tpu.scene import builder as jax_builder
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator import whitted
from distributionraytracer_tpu_torch.integrator.render import (
    render_from_samples,
)
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
from distributionraytracer_tpu_torch.ops import intersect as PI
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene import ACCEL_BVH, SceneBuilder

from test_torch_intersect import assert_hits_close
from test_whitted import small_scene as jax_small_scene
from torch_port_util import prim_scene, to_port, torch_samples
from torch_scenes import (
    mesh_scene, occlusion_inputs, random_rays, shadow_edge_scene,
    silhouette_scene,
)

torch.set_num_threads(1)

N_RAYS = 512
TAU = 0.05
# Both packages take the same f32 arithmetic in another operation order:
# each gradient element within RTOL of the largest |element| of JAX's.
RTOL = 1e-3
IMAGE_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_grads(got, ref):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert np.isfinite(got).all()
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale)


def _soft_inputs(seed):
    """prim_scene (every primitive type), shadow rays with distances and
    excluded ids, and a weight per ray for a scalar loss."""
    scene = prim_scene()
    o, d, dist, ex = occlusion_inputs(scene.static.n_objects, N_RAYS, seed)
    t = np.random.default_rng(seed).random(N_RAYS).astype(np.float32)
    w = np.cos(np.arange(N_RAYS, dtype=np.float32))
    return scene, o, d, t, dist, ex, w


SOFT_LEAVES = ("sph_center", "sph_radius", "tri_v0", "tri_e1", "box_min")


@pytest.mark.parametrize("mb", [False, True], ids=["static", "motion"])
def test_soft_visibility_matches_jax(mb):
    scene, o, d, t, dist, ex, w = _soft_inputs(5)
    js = scene.device_put()

    def jax_loss(leaves, o, d):
        s = dataclasses.replace(js, **leaves)
        v = jax_intersect.soft_visibility(s, o, d, jnp.asarray(t),
                                          jnp.asarray(dist), jnp.asarray(ex),
                                          TAU, mb)
        return jnp.sum(v * w), v

    leaves = {n: getattr(js, n) for n in SOFT_LEAVES}
    (_, ref), (g_leaves, g_o, g_d) = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        leaves, jnp.asarray(o), jnp.asarray(d))

    port = to_port(scene)
    xs = {n: getattr(port, n).clone().requires_grad_(True)
          for n in SOFT_LEAVES}
    po, pd = _t(o).requires_grad_(True), _t(d).requires_grad_(True)
    vis = PI.soft_visibility(dataclasses.replace(port, **xs), po, pd, _t(t),
                             _t(dist), _t(ex), TAU, mb)
    ref = np.asarray(ref)
    assert 0.05 < float((ref < 0.5).mean()) < 0.95  # occluded and lit rays
    np.testing.assert_allclose(vis.detach().numpy(), ref, atol=IMAGE_ATOL)
    grads = torch.autograd.grad((vis * _t(w)).sum(),
                                [xs[n] for n in SOFT_LEAVES] + [po, pd])
    for got, want in zip(grads, [g_leaves[n] for n in SOFT_LEAVES]
                         + [g_o, g_d]):
        _close_grads(got, want)


def test_triangle_edge_margin_and_aabb_entry_match_jax():
    rng = np.random.default_rng(3)
    o, d, _ = random_rays(N_RAYS, seed=4)
    v0, e1, e2 = (rng.normal(0, 1.5, (N_RAYS, 3)).astype(np.float32)
                  for _ in range(3))
    # unit boxes about a point along each ray (some behind its origin,
    # some around it), offset so that about half the rays miss theirs
    along = rng.uniform(-1.0, 4.0, (N_RAYS, 1))
    lo = (o + d * along + rng.normal(0, 0.6, (N_RAYS, 3)) - 0.5).astype(
        np.float32)
    hi = lo + np.float32(1.0)
    w = np.cos(np.arange(N_RAYS, dtype=np.float32))

    def jax_loss(v0, e1, e2, o, d):
        m, t = jax_intersect.triangle_edge_margin(o, d, v0, e1, e2)
        return jnp.sum(jnp.tanh(m) * w + 1e-2 * jnp.tanh(t) * w), (m, t)

    (_, (m_ref, t_ref)), g_ref = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in (v0, e1, e2, o, d)))
    xs = [_t(a).requires_grad_(True) for a in (v0, e1, e2, o, d)]
    m, t = PI.triangle_edge_margin(xs[3], xs[4], *xs[:3])
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(m_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(t_ref),
                               rtol=1e-4, atol=1e-4)
    loss = (torch.tanh(m) * _t(w) + 1e-2 * torch.tanh(t) * _t(w)).sum()
    for got, want in zip(torch.autograd.grad(loss, xs), g_ref):
        _close_grads(got, want)

    hit_ref, te_ref = jax_intersect.aabb_entry_t(*(jnp.asarray(a) for a in
                                                   (o, d, lo, hi)))
    hit, te = PI.aabb_entry_t(*(_t(a) for a in (o, d, lo, hi)))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    assert 0.05 < float(hit.float().mean()) < 0.95
    np.testing.assert_allclose(te.numpy(), np.asarray(te_ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mb", [False, True], ids=["static", "motion"])
def test_closest_hit_excluding_an_object_matches_jax(mb):
    scene = prim_scene()
    o, d, t = random_rays(N_RAYS, seed=8)
    ex = np.random.default_rng(9).integers(
        -1, scene.static.n_objects, N_RAYS).astype(np.int32)
    ref = jax_intersect.closest_hit_brute(
        scene.device_put(), jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
        mb, exclude_obj=jnp.asarray(ex))
    port = to_port(scene)
    h = PI.closest_hit_brute(port, _t(o), _t(d), _t(t), mb,
                             exclude_obj=_t(ex))
    assert_hits_close(ref, h)
    assert not (h.obj_id.numpy() == ex)[ex >= 0].any()
    full = PI.closest_hit_brute(port, _t(o), _t(d), _t(t), mb)
    assert (full.obj_id.numpy() == ex).any()  # an exclusion changed a hit

    def jax_t(c):
        s = dataclasses.replace(scene.device_put(), sph_center=c)
        h = jax_intersect.closest_hit_brute(
            s, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), mb,
            exclude_obj=jnp.asarray(ex))
        return jnp.sum(jnp.where(h.hit, h.t, 0.0) + h.normal[:, 0])

    g_ref = jax.grad(jax_t)(scene.device_put().sph_center)
    c = port.sph_center.clone().requires_grad_(True)
    h = PI.closest_hit_brute(dataclasses.replace(port, sph_center=c), _t(o),
                             _t(d), _t(t), mb, exclude_obj=_t(ex))
    loss = (torch.where(h.hit, h.t, 0.0) + h.normal[:, 0]).sum()
    _close_grads(torch.autograd.grad(loss, c)[0], g_ref)


COVER_LEAVES = ("sph_center", "sph_radius", "tri_v0", "tri_e2", "box_max")


@pytest.mark.parametrize("mb", [False, True], ids=["static", "motion"])
def test_primary_coverage_matches_jax(mb):
    """Both packages take the same winners (JAX's HitResult), so only the
    coverage formulas are compared."""
    scene = prim_scene()
    js = scene.device_put()
    o, d, t = random_rays(N_RAYS, seed=11)
    h = jax_intersect.closest_hit_brute(js, jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(t), mb)
    w = np.cos(np.arange(N_RAYS, dtype=np.float32))

    def jax_loss(leaves):
        s = dataclasses.replace(js, **leaves)
        a = jax_whitted.primary_coverage(s, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(t), h, TAU, mb)
        return jnp.sum(a * w), a

    (_, ref), g_ref = jax.value_and_grad(jax_loss, has_aux=True)(
        {n: getattr(js, n) for n in COVER_LEAVES})
    port = to_port(scene)
    ph = PI.HitResult(*(torch.from_numpy(np.array(a)) for a in h))
    xs = {n: getattr(port, n).clone().requires_grad_(True)
          for n in COVER_LEAVES}
    a = whitted.primary_coverage(dataclasses.replace(port, **xs), _t(o),
                                 _t(d), _t(t), ph, TAU, mb)
    ref = np.asarray(ref)
    assert int(((ref > 0.01) & (ref < 0.99)).sum()) >= 5  # lanes on a ramp
    np.testing.assert_allclose(a.detach().numpy(), ref, atol=IMAGE_ATOL)
    grads = torch.autograd.grad((a * _t(w)).sum(),
                                [xs[n] for n in COVER_LEAVES])
    for n, got in zip(COVER_LEAVES, grads):
        _close_grads(got, g_ref[n])


# ------------------------------------------------ whole renders against JAX
RENDERS = {
    # name: (JAX scene, config, leaf, loss columns)
    "soft-shadow-sphere": (lambda b: shadow_edge_scene(b, "sphere"),
                           dict(soft_shadow=0.05), "sph_center", 19),
    "soft-shadow-triangle": (lambda b: shadow_edge_scene(b, "triangle"),
                             dict(soft_shadow=0.05), "tri_v0", 19),
    "soft-silhouette-sphere": (silhouette_scene, dict(soft_silhouette=0.03),
                               "sph_center", 32),
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_soft_render_and_grad_match_jax(name):
    make, kw, leaf, cols = RENDERS[name]
    scene = make(jax_builder.SceneBuilder)
    js = scene.device_put()
    cfg = JaxConfig(spp=1, **kw)
    samples = jax_samples(js, cfg, jax.random.PRNGKey(0))

    def loss(x):
        img = jax_render(dataclasses.replace(js, **{leaf: x}), cfg, samples)
        return jnp.mean(img[:, :cols]), img

    (_, ref), g_ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        getattr(js, leaf))
    port = to_port(scene)
    x = getattr(port, leaf).clone().requires_grad_(True)
    img = render_from_samples(dataclasses.replace(port, **{leaf: x}),
                              RenderConfig(spp=1, **kw),
                              torch_samples(samples))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref),
                               atol=IMAGE_ATOL)
    (g,) = torch.autograd.grad(img[:, :cols].mean(), x)
    assert float(np.abs(np.asarray(g_ref)).max()) > 1e-3
    _close_grads(g, g_ref)


def test_soft_silhouette_counts_rays_as_jax():
    scene = jax_small_scene(glass=True)
    js = scene.device_put()
    cfg = JaxConfig(spp=1, soft_silhouette=0.03)
    samples = jax_samples(js, cfg, jax.random.PRNGKey(4))
    ref, ref_rays = jax.jit(lambda s, smp: jax_render(
        s, cfg, smp, return_rays=True))(js, samples)
    img, nrays = render_from_samples(
        to_port(scene), RenderConfig(spp=1, soft_silhouette=0.03,
                                     tile_rays=128),
        torch_samples(samples), return_rays=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), atol=2e-3)
    assert int(nrays) == int(ref_rays)


# ------------------------------------ test_grad's finite differences, port
# The port renders and differentiates; the scenes and SampleSets are
# test_grad's own (its keys, drawn by the JAX package), so that every
# mirror runs on its original's inputs.  The silhouette test's hard-gradient
# check compares with |dL/dx| of the soft gradient, which the draw decides
# (the frame is symmetric in x): on the port's own seed-0 draw it reads
# 0.0064, on test_grad's 0.0018.
def _case(jax_scene, leaf_cfg, key):
    """The port's scene and test_grad's SampleSet of ``key``."""
    samples = jax_samples(jax_scene.device_put(), JaxConfig(**leaf_cfg),
                          jax.random.PRNGKey(key))
    return to_port(jax_scene), torch_samples(samples)


def _loss_of(scene, cfg, samples, leaf, reduce):
    def f(x):
        img = render_from_samples(dataclasses.replace(scene, **{leaf: x}),
                                  cfg, samples)
        return reduce(img)
    return f


def _autograd(f, x0):
    x = x0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), x)
    return g.numpy()


def _fd_pairs(f, x0, g, picks, eps=1e-3):
    """(central difference, autodiff) at the ``picks`` largest-|g|
    coordinates, the perturbed points rounded to f32 as test_grad's."""
    flat = x0.numpy().astype(np.float64).ravel()
    out = []
    for i in np.argsort(-np.abs(g.ravel()))[:picks]:
        e = np.zeros_like(flat)
        e[i] = eps
        val = lambda v: float(f(torch.from_numpy(
            v.reshape(x0.shape).astype(np.float32))))
        out.append(((val(flat + e) - val(flat - e)) / (2 * eps),
                    g.ravel()[i]))
    return out


def _cos_loss(img):
    w = torch.cos(torch.arange(img.numel(), dtype=torch.float32))
    return (img * w.reshape(img.shape)).sum()


@pytest.mark.parametrize("kernels", ["auto", "off"])
@pytest.mark.parametrize("leaf", ["mat_cd", "mat_kd", "light_pos", "cam_eye",
                                  "sph_center"])
def test_grad_matches_finite_difference(leaf, kernels):
    scene, samples = _case(jax_small_scene(glass=True), dict(spp=1), 2)
    cfg = RenderConfig(spp=1, kernels=kernels)
    f = _loss_of(scene, cfg, samples, leaf, _cos_loss)
    x0 = getattr(scene, leaf)
    g = _autograd(f, x0)
    assert np.isfinite(g).all(), f"non-finite grad for {leaf}"
    with torch.no_grad():
        for fd, ad in _fd_pairs(f, x0, g, 3):
            # piecewise smooth: a difference across a discontinuity may
            # disagree, so a close match or both small
            if abs(fd) > 1e-3 or abs(ad) > 1e-3:
                assert abs(fd - ad) <= 0.12 * max(abs(fd), abs(ad)) + 1e-3, (
                    leaf, fd, ad)


def _fd_check(f, x0, g, picks=2, rtol=0.05):
    with torch.no_grad():
        for fd, ad in _fd_pairs(f, x0, g, picks):
            assert abs(fd - ad) <= rtol * max(abs(fd), abs(ad)) + 1e-4, (
                fd, ad)


@pytest.mark.parametrize("occluder,leaf", [("sphere", "sph_center"),
                                           ("triangle", "tri_v0")])
def test_soft_shadow_grad_matches_fd_at_edge(occluder, leaf):
    """At a shadow edge the relaxed visibility's autodiff matches central
    differences, where hard shadows give ~0."""
    scene, samples = _case(
        shadow_edge_scene(jax_builder.SceneBuilder, occluder),
        dict(spp=1, soft_shadow=0.05), 0)
    cfg = RenderConfig(spp=1, soft_shadow=0.05)
    f = _loss_of(scene, cfg, samples, leaf, lambda img: img[:, :19].mean())
    x0 = getattr(scene, leaf)
    g = _autograd(f, x0)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 1e-3, g
    _fd_check(f, x0, g)


def test_soft_silhouette_grad_matches_fd_at_sphere_edge():
    scene, samples = _case(silhouette_scene(jax_builder.SceneBuilder),
                           dict(spp=1, soft_silhouette=0.03), 0)
    cfg = RenderConfig(spp=1, soft_silhouette=0.03)
    f = _loss_of(scene, cfg, samples, "sph_center", torch.mean)
    x0 = scene.sph_center
    g = _autograd(f, x0)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 1e-3, g
    _fd_check(f, x0, g)
    # the hard renderer's pointwise gradient lacks the silhouette's
    # boundary term: off by an order of magnitude
    gh = _autograd(_loss_of(scene, cfg.replace(soft_silhouette=0.0), samples,
                            "sph_center", torch.mean), x0)
    assert np.abs(gh - g).max() > 10 * np.abs(g[..., 0]).max()


@pytest.mark.parametrize("knob", ["soft_shadow", "soft_silhouette"])
def test_soft_off_is_reference(knob):
    """A width of 0 leaves the reference path bit-identical."""
    scene, samples = _case(jax_small_scene(), dict(spp=1), 1)
    cfg = RenderConfig(spp=1)
    a = render_from_samples(scene, cfg, samples)
    b = render_from_samples(scene, cfg.replace(**{knob: 0.0}), samples)
    assert torch.equal(a, b)


# ---------------------------------------------------------------- routing
def test_soft_shadow_routes_to_the_staged_levels_and_builds_no_bins():
    scene = to_port(prim_scene())
    soft = RenderConfig(soft_shadow=0.05)
    assert not CW.fused_supported(scene, soft)
    assert CW.fused_supported(scene, RenderConfig())
    assert whitted.level_route(scene, soft) == "brute-kernel"
    assert whitted.level_route(scene, soft.replace(kernels="off")) == "plain"
    mesh = mesh_scene(SceneBuilder, n_tri=2000, accel=ACCEL_BVH,
                      res=(16, 16))
    hard = Renderer(mesh, RenderConfig(spp=0), device="cpu")
    assert hard._gbox is not None
    assert hard.executed_backend().startswith("binned-primary+")
    r = Renderer(mesh, RenderConfig(spp=0, soft_shadow=0.05), device="cpu")
    assert r._gbox is None and r._light_bins is None
    assert r.executed_backend() == "grouped-packet"
    for bad in (dict(soft_shadow=-0.1), dict(soft_silhouette=-1.0),
                dict(soft_shadow=float("nan"))):
        with pytest.raises(ValueError):
            RenderConfig(**bad)
