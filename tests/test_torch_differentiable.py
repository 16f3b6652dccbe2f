"""The port's differentiable intersectors and the kernels' gradient guard,
on the CPU.

``accel_intersectors(..., None, differentiable=True)`` is held against the
JAX package on ``test_grad``'s cosine loss (``small_scene(glass=True)``,
spp 1, one SampleSet for both): the image against JAX's differentiable
route, the gradients of ``test_torch_grad``'s five leaves against JAX's
plain autodiff (``jax.grad`` of the same render).  JAX's own
differentiable route matches those for ``mat_cd``, ``mat_kd`` and
``light_pos`` and is NaN for ``cam_eye`` and ``sph_center``: its
``hit_packed`` takes ``sqrt(max(disc, 0))``, whose backward at a miss lane
is 0 * inf; the port's ``hit_packed`` takes ``safe_sqrt``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.integrator.render import (
    render_from_samples as jax_render,
)
from distributionraytracer_tpu.parallel.mesh import (
    accel_intersectors as jax_accel_intersectors,
)
from distributionraytracer_tpu_torch.accel import cuda_bvh as CBV
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    make_samples, render_from_samples,
)
from distributionraytracer_tpu_torch.integrator.whitted import (
    differentiable_intersectors,
)
from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
from distributionraytracer_tpu_torch.ops import cuda_pt as CP
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
from distributionraytracer_tpu_torch.parallel.mesh import (
    accel_intersectors, detached, l2_render_loss,
)
from distributionraytracer_tpu_torch.renderer import (
    Renderer, _brute_bvh_intersectors, build_accel,
)
from distributionraytracer_tpu_torch.scene import (
    ACCEL_BVH, ACCEL_GRID, SCENE_BUILDERS, SceneBuilder,
)

from test_torch_grad import LEAVES, RTOL
from test_torch_render import shared_samples
from test_whitted import small_scene
from torch_port_util import prim_scene, to_port, torch_samples
from torch_scenes import mesh_scene, random_rays

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    """The JAX scene, its SampleSet, JAX's differentiable-route image and
    JAX's plain-autodiff gradients of every leaf."""
    scene = small_scene(glass=True)
    samples = shared_samples(scene, 1, seed=2)
    js = scene.device_put()

    def loss(leaves, cfg, diff):
        s = dataclasses.replace(js, **leaves)
        inter = (jax_accel_intersectors(s, cfg, None, differentiable=True)
                 if diff else None)
        img = jax_render(s, cfg, samples, inter=inter)
        return jnp.sum(img * jnp.cos(jnp.arange(img.size).reshape(
            img.shape))), img

    leaves = {n: getattr(js, n) for n in LEAVES}
    grads = jax.jit(jax.grad(lambda lv: loss(lv, JaxConfig(spp=1), False)[0])
                    )(leaves)
    img = jax.jit(lambda lv: loss(lv, JaxConfig(spp=1, pallas="off"),
                                  True)[1])(leaves)
    return (scene, samples, np.asarray(img),
            {n: np.asarray(g) for n, g in grads.items()})


def _cos_loss(img):
    w = torch.cos(torch.arange(img.numel(), dtype=torch.float32))
    return (img * w.reshape(img.shape)).sum()


@pytest.mark.parametrize("kernels", ["auto", "off"])
@pytest.mark.parametrize("leaf", LEAVES)
def test_differentiable_route_matches_jax(case, leaf, kernels):
    """``kernels='auto'``: the K1/K2 wrappers as the base (their plain
    versions on CPU tensors); ``'off'``: the plain scans."""
    scene, samples, ref_img, ref = case
    port = to_port(scene)
    x = getattr(port, leaf).clone().requires_grad_(True)
    sc = dataclasses.replace(port, **{leaf: x})
    cfg = RenderConfig(spp=1, kernels=kernels)
    inter = accel_intersectors(sc, cfg, None, differentiable=True)
    img = render_from_samples(sc, cfg, torch_samples(samples), inter=inter)
    np.testing.assert_allclose(img.detach().numpy(), ref_img, atol=1e-4)
    (g,) = torch.autograd.grad(_cos_loss(img), x)
    g, r = g.numpy(), ref[leaf]
    assert np.isfinite(g).all(), f"non-finite gradient for {leaf}"
    scale = float(np.abs(r).max())
    assert scale > 1e-2, (leaf, scale)
    np.testing.assert_allclose(g, r, rtol=0, atol=RTOL * scale)


PRIM_LEAVES = ("sph_center", "sph_radius", "tri_v0", "tri_e1", "pln_n",
               "box_min", "mat_cd")


@pytest.mark.parametrize("mb", [False, True], ids=["static", "motion"])
def test_differentiable_route_on_every_primitive_type(mb):
    """On a scene of all four types the recomputed hits' gradients are
    finite and those of plain autodiff: ``hit_packed`` evaluates each
    type's formula on every lane, and the triangle normal of another
    type's row is the zero vector."""
    scene = to_port(prim_scene())
    cfg = RenderConfig(spp=2, motion_blur=mb)
    samples = make_samples(scene, cfg, torch.Generator().manual_seed(7))
    target = render_from_samples(scene, cfg, samples) * 0.9
    out = []
    for diff in (True, False):
        xs = [getattr(scene, n).clone().requires_grad_(True)
              for n in PRIM_LEAVES]
        sc = dataclasses.replace(scene, **dict(zip(PRIM_LEAVES, xs)))
        inter = (accel_intersectors(sc, cfg, None, differentiable=True)
                 if diff else None)
        loss = l2_render_loss(sc, cfg.replace(kernels="off"), samples,
                              target, inter=inter)
        out.append((float(loss.detach()), torch.autograd.grad(loss, xs)))
    (l0, g0), (l1, g1) = out
    assert l1 > 0 and abs(l0 - l1) <= 1e-4 * l1
    for name, a, b in zip(PRIM_LEAVES, g0, g1):
        assert torch.isfinite(a).all(), name
        scale = float(b.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(a, b, rtol=0, atol=RTOL * scale)


def test_packet_tables_route_matches_brute_route():
    """The K7 variant (its plain walk on CPU tensors) gives the brute
    variant's loss and gradients on a small BVH mesh scene.  The brute
    variant takes the BVH's shadow compare (the renderer's cost-brute
    intersectors): ``accel_intersectors(..., None)`` takes accel NONE's,
    as the JAX package's does, which excludes the shaded object from its
    own shadow rays where a BVH does not (bvh.cpp:376)."""
    scene = mesh_scene(SceneBuilder, n_tri=300, accel=ACCEL_BVH,
                       res=(16, 12))
    cfg = RenderConfig(spp=1)
    tabs = Renderer(scene, cfg, device="cpu").tabs
    assert tabs.kind == "grouped"
    samples = make_samples(scene, cfg, torch.Generator().manual_seed(3))
    target = render_from_samples(scene, cfg, samples).detach() * 0.9
    out = []
    for accel in (None, tabs):
        cd = scene.mat_cd.clone().requires_grad_(True)
        c = scene.sph_center.clone().requires_grad_(True)
        sc = dataclasses.replace(scene, mat_cd=cd, sph_center=c)
        if accel is None:
            inter = differentiable_intersectors(
                sc, cfg, _brute_bvh_intersectors(detached(sc), cfg))
        else:
            inter = accel_intersectors(sc, cfg, accel, differentiable=True)
        loss = l2_render_loss(sc, cfg, samples, target, inter=inter)
        out.append((float(loss.detach()),
                    *torch.autograd.grad(loss, (cd, c))))
    (l0, *g0), (l1, *g1) = out
    assert l0 > 0 and abs(l1 - l0) <= 1e-4 * l0
    for a, b in zip(g0, g1):
        assert torch.isfinite(b).all() and float(a.abs().max()) > 0
        torch.testing.assert_close(b, a, rtol=0,
                                   atol=RTOL * float(a.abs().max()))


def test_accel_intersectors_refusals_and_pass_through():
    scene = mesh_scene(SceneBuilder, n_tri=300, accel=ACCEL_BVH,
                       res=(16, 12))
    cfg = RenderConfig(spp=1)
    assert accel_intersectors(scene, cfg, None) is None
    ab = build_accel(scene)
    assert accel_intersectors(scene, cfg, ab.tabs) is not None
    gb = build_accel(dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, accel=ACCEL_GRID)))
    # every table type of a grid or BVH scene passes: the
    # threaded walk, the DDA and the grid emulation
    for tables in (ab.host, gb.host, gb.tabs):
        for diff in (False, True):
            assert accel_intersectors(scene, cfg, tables,
                                      differentiable=diff) is not None
    with pytest.raises(TypeError, match="unknown accel tables"):
        accel_intersectors(scene, cfg, object(), differentiable=True)


def test_l2_render_loss_and_detached():
    scene = to_port(small_scene())
    cfg = RenderConfig(spp=1)
    samples = make_samples(scene, cfg, torch.Generator().manual_seed(1))
    img = render_from_samples(scene, cfg, samples)
    assert float(l2_render_loss(scene, cfg, samples, img)) == 0.0
    loss = l2_render_loss(scene, cfg, samples, img + 0.5)
    assert abs(float(loss) - float(torch.mean((img - img - 0.5) ** 2))) < 1e-6
    x = scene.mat_cd.clone().requires_grad_(True)
    d = detached(dataclasses.replace(scene, mat_cd=x))
    assert not any(getattr(d, n).requires_grad
                   for n in type(d)._LEAF_NAMES)
    assert torch.equal(d.mat_cd, scene.mat_cd) and d.static == scene.static


# --------------------------------------------------------------- the guard
def test_guard_refuses_tensors_that_require_grad():
    a = torch.zeros(4, requires_grad=True)
    b = torch.zeros(4)
    with pytest.raises(RuntimeError, match="differentiable=True"):
        CI.refuse_grad("closest_hit", b, a)
    with pytest.raises(RuntimeError, match="closest_hit"):
        CI.refuse_grad("closest_hit", a * 2)
    CI.refuse_grad("closest_hit", b, a.detach())
    with torch.no_grad():
        CI.refuse_grad("closest_hit", a)
    # every wrapper's first check, before the device's
    with pytest.raises(RuntimeError, match="forward-only"):
        CI.require_cuda("any_hit", b, a)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CI.require_cuda("any_hit", b, a.detach())


def test_guard_covers_the_tables():
    """Tables built from a leaf that requires a gradient trip the guard;
    those of the detached scene do not."""
    scene = to_port(small_scene(glass=True))
    x = scene.sph_center.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, sph_center=x)
    for tabs in (CI.object_tables(sc), CW.level_tables(sc)):
        floats = [t for t in tabs if isinstance(t, torch.Tensor)]
        assert any(t.requires_grad for t in floats)
        with pytest.raises(RuntimeError):
            CI.refuse_grad("tables", *floats)
        with torch.no_grad():
            CI.refuse_grad("tables", *floats)
    for tabs in (CI.object_tables(detached(sc)),
                 CW.level_tables(detached(sc))):
        CI.refuse_grad("tables", *[t for t in tabs
                                   if isinstance(t, torch.Tensor)])


def test_kernel_wrappers_refuse_rays_that_require_grad():
    """Each wrapper checks its rays before their device: on CPU tensors
    that require a gradient, K1-K8 raise the guard's RuntimeError."""
    scene = to_port(small_scene(glass=True))
    o, d, t = (torch.from_numpy(a) for a in random_rays(8, seed=2))
    o = o.requires_grad_(True)
    z = torch.zeros(8)
    v = torch.ones(8, dtype=torch.bool)
    calls = {
        "K1": lambda: CI.closest_hit_kernel(scene, o, d, t, False),
        "K2": lambda: CI.any_hit_kernel(scene, o, d, z + 1, None, False),
        "K3": lambda: CW.fused_level_kernel(
            scene, RenderConfig(), o, d, t, z + 1, torch.zeros((8, 3)), v,
            spawn=True),
    }
    pts = SCENE_BUILDERS[0]()
    calls["K4"] = lambda: CP.pt_closest_kernel(pts, o, d, t)
    calls["K5"] = lambda: CP.pt_any_hit_kernel(pts, o, d, t, 10.0)
    n_u = CP.UNIFORM_ROWS + 2 * CP.pt_tables(pts).qlights.shape[0]
    calls["K6"] = lambda: CP.pt_bounce_kernel(
        pts, CP.bounce_state(o, d, t), torch.zeros((n_u, 8)), True)
    mesh = mesh_scene(SceneBuilder, n_tri=300, accel=ACCEL_BVH, res=(8, 8))
    grouped = build_accel(mesh).tabs
    threaded = build_accel(mesh, packet_kernel="legacy").tabs
    assert (grouped.kind, threaded.kind) == ("grouped", "threaded")
    calls["K7"] = lambda: CBV.packet_closest_kernel(grouped, o, d, t)
    calls["K8"] = lambda: CBV.packet_shadow_kernel(threaded, o, d, z + 1)
    for k, call in calls.items():
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
        with torch.no_grad():
            with pytest.raises(ValueError, match="CUDA"):
                call()
