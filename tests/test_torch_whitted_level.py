"""Port fused level (plain version of K3) vs the JAX package's
``fused_level`` in interpret mode, on valid lanes (the CUDA kernel writes
zeros to the others)."""

import numpy as np
import pytest
import torch

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.ops import pallas_whitted as PW
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
from distributionraytracer_tpu_torch.ops.intersect import closest_hit_brute

from torch_port_util import prim_scene, to_port
from torch_scenes import compare_levels, level_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize("spawn", [True, False], ids=["spawn", "leaf"])
@pytest.mark.parametrize("shadow_mode", ["reference", "correct"])
@pytest.mark.parametrize("mb", [False, True], ids=["static", "motion"])
def test_fused_level_plain_matches_jax(spawn, shadow_mode, mb):
    scene = prim_scene()
    o, d, t, ior, ls, valid = level_inputs(512, seed=11)
    jcfg = JaxConfig(motion_blur=mb, shadow_mode=shadow_mode)
    ref = PW.fused_level(scene.device_put(), jcfg, o, d, t, ior, ls, valid,
                         spawn=spawn, interpret=True)
    cfg = RenderConfig(motion_blur=mb, shadow_mode=shadow_mode)
    tt = torch.from_numpy
    res = CW.fused_level_plain(to_port(scene), cfg, tt(o), tt(d), tt(t),
                               tt(ior), tt(ls), tt(valid), spawn=spawn)
    hit = res["_hit"].numpy() & valid
    assert 0.2 < hit.mean() < 0.9
    lit = (res["direct"].numpy().sum(-1) > 0) & hit
    assert 0.05 < lit.mean() < hit.mean()  # some lanes shadowed, some lit
    if spawn:
        assert res["refr_valid"].numpy().any()
        assert res["refl_valid"].numpy().any()
    compare_levels(ref, res, valid)


def test_fused_level_plain_ties_match_jax():
    """On a scene whose spheres and triangles are each listed twice, the
    copies later and in other materials, the plain K3 and JAX
    ``fused_level`` in interpret mode agree, and every tie in t goes to the
    lower object id (the rule the kernels' group reduction reproduces):
    ids and materials equal those on the scene without the copies."""
    scene = prim_scene(ties=True)
    o, d, t, ior, ls, valid = level_inputs(512, seed=13)
    ref = PW.fused_level(scene.device_put(), JaxConfig(), o, d, t, ior, ls,
                         valid, spawn=True, interpret=True)
    tt = torch.from_numpy
    port = to_port(scene)
    res = CW.fused_level_plain(port, RenderConfig(), tt(o), tt(d), tt(t),
                               tt(ior), tt(ls), tt(valid), spawn=True)
    compare_levels(ref, res, valid)
    h = closest_hit_brute(port, tt(o), tt(d), tt(t), False)
    h0 = closest_hit_brute(to_port(prim_scene()), tt(o), tt(d), tt(t), False)
    assert torch.equal(h.obj_id, h0.obj_id)
    assert torch.equal(h.mat_id, h0.mat_id)
    # the spheres (ids 0, 4) and triangles (2, 5) that have copies
    tied = np.isin(h.obj_id.numpy(), [0, 2, 4, 5])
    assert tied[valid].sum() >= 20


def test_pack_whitted_mats_equal_jax():
    scene = prim_scene()
    np.testing.assert_array_equal(
        np.asarray(PW.pack_whitted_mats(scene.device_put())),
        CW.pack_whitted_mats(to_port(scene)).numpy())


def test_fused_supported_and_cpu_dispatch():
    scene = to_port(prim_scene())
    cfg = RenderConfig()
    assert CW.fused_supported(scene, cfg)
    o, d, t, ior, ls, valid = (torch.from_numpy(a)
                               for a in level_inputs(64, seed=3))
    CW.reset_launches()
    a = CW.fused_level(scene, cfg, o, d, t, ior, ls, valid, spawn=True)
    b = CW.fused_level_plain(scene, cfg, o, d, t, ior, ls, valid, spawn=True)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert CW.LAUNCHES["fused_level"] == 0
