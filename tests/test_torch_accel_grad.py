"""Gradients through grid and BVH scenes, on the CPU.

``accel_intersectors(..., differentiable=True)`` on each table type of a
grid scene (``GridArrays``: the plain DDA; ``CudaGrid``: the emulation's
plain walk, K7's plain version) and of a BVH scene (``ThreadedBVH``: the
plain walk of the full tree; ``PacketTables``: K7's plain version) against
the JAX package's ``accel_intersectors(GridArrays | ThreadedBVH,
differentiable=True)``, on ``small_scene(glass=True)`` with the scene's
accel set, spp 1, one SampleSet for both.  The loss weights each pixel
channel by ``1.5 + cos(k)``: positive weights, so that the loss does not
cancel and its relative error means something.

- The loss within rel 1e-5 of JAX's; the gradients of ``mat_cd``,
  ``mat_kd`` and ``light_pos`` within 1e-4 of the largest element of JAX's.
- JAX's differentiable route is NaN in ``cam_eye`` and ``sph_center`` (its
  ``hit_packed`` takes ``sqrt(max(disc, 0))``, whose backward at a lane
  that misses a sphere's row is 0 * inf; ``test_torch_differentiable.py``
  documents the same on accel NONE).  Those two are held against the
  port's plain autodiff through a traversal that differentiates as it
  walks, the DDA (grid) or the stack walk (BVH), within 1e-4 of its
  largest element.
- Central finite differences on ``light_pos`` through the DDA route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributionraytracer_tpu.accel import bvh as jbvh
from distributionraytracer_tpu.accel import grid as jgrid
from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.integrator.render import (
    render_from_samples as jax_render,
)
from distributionraytracer_tpu.parallel.mesh import (
    accel_intersectors as jax_accel_intersectors,
)
from distributionraytracer_tpu_torch.accel import bvh as tbvh
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    render_from_samples,
)
from distributionraytracer_tpu_torch.parallel.mesh import accel_intersectors
from distributionraytracer_tpu_torch.renderer import build_accel
from distributionraytracer_tpu_torch.scene.types import (
    ACCEL_BVH, ACCEL_GRID,
)

from test_torch_render import shared_samples
from test_whitted import small_scene
from torch_port_util import to_port, torch_samples

torch.set_num_threads(1)

LEAVES = ("mat_cd", "mat_kd", "light_pos", "cam_eye", "sph_center")
JAX_FINITE = ("mat_cd", "mat_kd", "light_pos")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # of the largest |element| of the reference gradient
KINDS = {"grid": ACCEL_GRID, "bvh": ACCEL_BVH}


def _weights(shape, xp):
    return (1.5 + xp.cos(xp.arange(int(np.prod(shape)))).reshape(shape))


def _port_loss(img):
    return (img * _weights(img.shape, torch).to(torch.float32)).sum()


def _with_accel(scene, accel):
    return dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, accel=accel))


@pytest.fixture(scope="module", params=sorted(KINDS))
def case(request):
    """The JAX scene with its accel, the port's, the SampleSet, and JAX's
    loss and gradients through its differentiable route."""
    js = _with_accel(small_scene(glass=True), KINDS[request.param])
    samples = shared_samples(js, 1, seed=2)
    jd = js.device_put()
    cfg = JaxConfig(spp=1)
    if request.param == "grid":
        tabs = jgrid.build_grid(js)
        unroll = jgrid._pick_unroll(tabs.cell_start)
    else:
        tabs, unroll = jbvh.thread_bvh(jbvh.build_bvh(js)), None

    def loss(leaves):
        s = dataclasses.replace(jd, **leaves)
        inter = jax_accel_intersectors(s, cfg, tabs, grid_unroll=unroll,
                                       differentiable=True)
        img = jax_render(s, cfg, samples, inter=inter)
        return jnp.sum(img * _weights(img.shape, jnp))

    value, grads = jax.jit(jax.value_and_grad(loss))(
        {n: getattr(jd, n) for n in LEAVES})
    port = to_port(js)
    return dict(kind=request.param, port=port, samples=samples,
                ab=build_accel(port), loss=float(value),
                grads={n: np.asarray(g) for n, g in grads.items()},
                plain={})


def _port_grad(scene, leaf, samples, inter_of):
    """The loss and its gradient in ``leaf`` through ``inter_of(scene,
    cfg)``'s intersectors."""
    x = getattr(scene, leaf).clone().requires_grad_(True)
    sc = dataclasses.replace(scene, **{leaf: x})
    cfg = RenderConfig(spp=1)
    loss = _port_loss(render_from_samples(sc, cfg, torch_samples(samples),
                                          inter=inter_of(sc, cfg)))
    (g,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), g.numpy()


def _plain_autodiff(case, leaf):
    """The gradient by autodiff through a traversal that differentiates as
    it walks: the DDA, or the stack walk over the same build."""
    if leaf not in case["plain"]:
        ps = case["port"]
        if case["kind"] == "grid":
            host = case["ab"].host
            inter_of = lambda sc, cfg: accel_intersectors(sc, cfg, host)
        else:
            bvh = tbvh.build_bvh(ps)
            inter_of = lambda sc, cfg: tbvh.make_bvh_intersectors(sc, bvh)
        case["plain"][leaf] = _port_grad(ps, leaf, case["samples"],
                                         inter_of)[1]
    return case["plain"][leaf]


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("tables", ["host", "packet"])
def test_accel_gradients_match_jax(case, tables, leaf):
    """``host``: GridArrays / ThreadedBVH (the plain traversals);
    ``packet``: CudaGrid / PacketTables (the kernels' plain versions)."""
    ab = case["ab"]
    tabs = ab.host if tables == "host" else ab.tabs
    loss, g = _port_grad(case["port"], leaf, case["samples"],
                         lambda sc, cfg: accel_intersectors(
                             sc, cfg, tabs, differentiable=True))
    assert abs(loss - case["loss"]) <= LOSS_RTOL * abs(case["loss"])
    assert np.isfinite(g).all(), f"non-finite gradient for {leaf}"
    if leaf in JAX_FINITE:
        ref = case["grads"][leaf]
    else:
        assert not np.isfinite(case["grads"][leaf]).all()  # JAX's fault
        ref = _plain_autodiff(case, leaf)
    scale = float(np.abs(ref).max())
    assert scale > 1e-2, (leaf, scale)
    np.testing.assert_allclose(g, ref, rtol=0, atol=GRAD_RTOL * scale)


def test_dda_route_matches_finite_differences():
    """d(loss)/d(light_pos) through ``accel_intersectors(GridArrays,
    differentiable=True)`` against central differences (eps 1e-3, at the
    two largest-|gradient| components, 5% + 1e-4, as test_grad's
    ``_fd_check``)."""
    ps = to_port(_with_accel(small_scene(glass=True), ACCEL_GRID))
    host = build_accel(ps).host
    samples = torch_samples(shared_samples(ps, 1, seed=2))
    cfg = RenderConfig(spp=1)

    def loss_of(lp):
        sc = dataclasses.replace(ps, light_pos=lp)
        inter = accel_intersectors(sc, cfg, host, differentiable=True)
        return _port_loss(render_from_samples(sc, cfg, samples, inter=inter))

    x = ps.light_pos.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_of(x), x)
    g = g.numpy().ravel()
    eps = 1e-3
    for i in np.argsort(-np.abs(g))[:2]:
        e = torch.zeros(g.size)
        e[i] = eps
        e = e.reshape(ps.light_pos.shape)
        with torch.no_grad():
            fd = (float(loss_of(ps.light_pos + e))
                  - float(loss_of(ps.light_pos - e))) / (2 * eps)
        assert abs(fd - g[i]) <= 0.05 * max(abs(fd), abs(g[i])) + 1e-4, (
            i, fd, g[i])
