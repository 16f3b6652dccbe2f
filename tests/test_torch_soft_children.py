"""Soft silhouettes on a tree with one child kind: the port's child levels
trace the full scene, the JAX package's do not.

``trace_whitted_soft`` forces the silhouette candidate (``c_with``) and
excludes it (``c_without``) on the primary level.  The JAX package tests
the primary call by its width, ``o2.shape[0] == R``; in a tree with only
reflection (or only refraction) every child level has that width too, so
it forces and excludes the primary's candidate on the children's rays,
which are other rays (``integrator/whitted.py:722-750``).  The port takes
the first closest call only (``primary_first``) and does not copy the
fault.  On ``small_scene()`` (metal and red spheres with ``ks > 0``, no
glass):

- every child-level closest call of the port's two traces returns
  ``closest_hit_brute`` of its own rays, exactly;
- the two packages' images (soft_silhouette 0.05, one ray set) agree
  within 2e-3 on every pixel whose primary lane has no candidate or
  spawns no child, and part (by more than 1e-2) somewhere among those
  JAX forces.
"""

import jax.numpy as jnp
import numpy as np
import torch

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.integrator import whitted as jax_whitted
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator import whitted as W
from distributionraytracer_tpu_torch.integrator.render import (
    _rays_from_samples,
)
from distributionraytracer_tpu_torch.ops.intersect import closest_hit_brute
from distributionraytracer_tpu_torch.scene.types import OBJ_PLANE

from test_torch_render import shared_samples
from test_whitted import small_scene
from torch_port_util import to_port, torch_samples

torch.set_num_threads(1)

TAU = 0.05


def _case():
    js = small_scene()
    port = to_port(js)
    st = port.static
    assert st.any_refl and not st.any_refr  # one child per node
    cfg = RenderConfig(spp=2, kernels="off", soft_silhouette=TAU)
    samples = torch_samples(shared_samples(js, 2, seed=3))
    return js, port, cfg, _rays_from_samples(port, cfg, samples)


def test_child_levels_trace_the_full_scene(monkeypatch):
    _, port, cfg, (o, d, t, ls) = _case()
    runs = []
    trace = W.trace_whitted

    def recording(scene, cfg_, o_, d_, t_, ls_, inter=None, **kw):
        calls = []
        runs.append(calls)

        def closest(o2, d2, t2, valid=None):
            h = inter.closest(o2, d2, t2, valid=valid)
            calls.append((o2, d2, t2, h))
            return h
        return trace(scene, cfg_, o_, d_, t_, ls_,
                     inter=W.Intersectors(closest, inter.shadow), **kw)

    monkeypatch.setattr(W, "trace_whitted", recording)
    W.trace_whitted_soft(port, cfg, o, d, t, ls)
    assert len(runs) == 2  # c_with and c_without
    R = o.shape[0]
    h1 = closest_hit_brute(port, o, d, t, False)
    for calls in runs:
        assert len(calls) == cfg.max_depth + 1
        assert all(c[0].shape[0] == R for c in calls)  # JAX's width test
        for o2, d2, t2, h in calls[1:]:
            ref = closest_hit_brute(port, o2, d2, t2, False)
            for a, b in zip(h, ref):
                assert torch.equal(a, b)
    # the primary calls do differ from the hard scan: c_with forces the
    # candidate sphere, c_without excludes the winner
    assert not torch.equal(runs[0][0][3].obj_id, h1.obj_id)
    assert not torch.equal(runs[1][0][3].obj_id, h1.obj_id)


def test_images_part_only_where_jax_forces_a_child_level():
    js, port, cfg, (o, d, t, ls) = _case()
    got, _ = W.trace_whitted_soft(port, cfg, o, d, t, ls)
    J = lambda x: jnp.asarray(x.numpy())
    ref, _ = jax_whitted.trace_whitted_soft(
        js.device_put(), JaxConfig(spp=2, soft_silhouette=TAU), J(o), J(d),
        J(t), J(ls))
    diff = np.abs(got.numpy() - np.asarray(ref)).max(-1)
    # the candidate of each lane (the port's own, the JAX package's rule)
    h1 = closest_hit_brute(port, o, d, t, False)
    ns = W._near_sphere(port, o, d, t, False)
    wtype = W._object_table(port, "obj_types", h1.obj_id)
    solid = h1.hit & (wtype != OBJ_PLANE)
    sph_ok = ns["has"] & (ns["proj"] < h1.t) & ~solid
    cand = solid | sph_ok
    # a child level exists where the primary material (the forced sphere's
    # under c_with) reflects: JAX forces or excludes there
    ks = port.mat_ks
    spawns = ((h1.hit & (ks[torch.clamp(h1.mat_id, min=0).long()] > 0))
              | (sph_ok & (ks[ns["mat"].long()] > 0)))
    forced = (cand & spawns).numpy()
    assert 0.05 < forced.mean() < 0.95
    assert diff[~forced].max() <= 2e-3, diff[~forced].max()
    assert diff[forced].max() > 1e-2
