"""The port's CUDA kernels vs their plain versions, on the card.

Needs no JAX, so it runs where the card is:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test here skips on a machine without a CUDA device.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator import pathtracer as PT
from distributionraytracer_tpu_torch.integrator import render as RD
from distributionraytracer_tpu_torch.integrator.render import (
    default_config, make_samples, render_from_samples,
)
from distributionraytracer_tpu_torch.integrator.whitted import (
    Intersectors, _tree_shape, brute_intersectors, trace_whitted,
)
from distributionraytracer_tpu_torch.ops import build
from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
from distributionraytracer_tpu_torch.ops import cuda_pt as CP
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
from distributionraytracer_tpu_torch.ops.intersect import (
    any_hit_brute, closest_hit_brute,
)
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene import (
    SCENE_BUILDERS, SceneBuilder, create_random_scene,
)

from distributionraytracer_tpu_torch.scene import pt_scenes as PS

from torch_level_chain import old_trace_k3
from torch_scenes import (
    compare_levels, crowd_scene, level_inputs, occlusion_inputs,
    one_kind_scene, prim_scene, PT_PRIM_LEAVES, PT_VIEWS, pt_crowd_leaves,
    pt_own_material_leaves, pt_rays, pt_tie_leaves, random_rays,
    synthetic_faces, tie_rays, tie_scene, with_skybox,
)

torch.set_num_threads(1)

N = 65536
BUDGET = 1e-4  # share of lanes that may differ at measure-zero edges (FMA)
COUNT_BUDGET = 1e-3  # a lane that flips takes its subtree's rays with it

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """A CUDA device, or a skip where the machine has no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _cuda(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _mismatch(a, b):
    return float((a != b).float().mean())


def test_kernels_build_for_sm90a(dev):
    built = build.load()
    assert built.path.startswith(build.BUILD_DIR)
    for name in build.SIGNATURES:
        assert hasattr(built.lib, name)


@pytest.mark.parametrize("mb", [False, True], ids=["static", "motion"])
def test_closest_hit_kernel_matches_plain(dev, mb):
    scene = prim_scene(SceneBuilder).to(dev)
    o, d, t = _cuda(dev, *random_rays(N, seed=6))
    valid = torch.rand(N, device=dev) < 0.9
    ref = closest_hit_brute(scene, o, d, t, mb)
    h = CI.closest_hit_kernel(scene, o, d, t, mb, valid=valid)
    torch.cuda.synchronize()
    assert not h.hit[~valid].any()
    ids = valid & ((ref.hit != h.hit) | (ref.obj_id != h.obj_id)
                   | (ref.hit & (ref.mat_id != h.mat_id)))
    same = valid & ~ids & ref.hit
    near = lambda a, b: (a - b).abs() <= 1e-4 + 1e-4 * b.abs()
    off = same & ~(near(h.t, ref.t) & near(h.normal, ref.normal).all(-1))
    # hit/miss edges and tangent sphere hits (ill-conditioned t) may move
    assert float((ids | off).float().mean()) <= BUDGET


# K1 cases: the scene, motion blur, the share of valid lanes (None: no
# valid input) and the lane count
K1_CASES = {
    "spheres-102": ("random", False, None, N),
    "spheres-102-sparse": ("random", False, 0.03, N),
    "spheres-102-deep": ("random", False, 0.05, 8 * N),
    "spheres-102-motion": ("random", True, None, N),
    "cost-brute-1005": ("mesh", False, None, N),
    "cost-brute-1005-sparse": ("mesh", False, 0.05, N),
    "cost-brute-1005-motion": ("mesh", True, 0.05, N),
    "cost-brute-1005-ragged": ("mesh", False, 0.9, N - 37),
    "ties-motion": ("ties", True, 0.9, N),
    "ties-across-runs": ("tie-runs", False, None, N),
    "ties-across-runs-motion": ("tie-runs", True, 0.5, N - 5),
}


def _k1_inputs(dev, case):
    """(scene, o, d, time, motion blur, valid or None) on the card."""
    kind, mb, share, n = K1_CASES[case]
    if kind == "random":
        scene = create_random_scene(0)
        o, d, t = random_rays(n, seed=61, spread=5.0)
    elif kind == "mesh":  # 1,000 triangles, four spheres and the ground
        scene = mesh_scene(SceneBuilder, n_tri=1000, accel=ACCEL_BVH,
                           res=(64, 64))
        o, d, _, _ = accel_rays(n, seed=62)
        t = np.random.default_rng(62).random(n).astype(np.float32)
    elif kind == "ties":
        scene = prim_scene(SceneBuilder, ties=True)
        o, d, t = random_rays(n, seed=63)
    else:
        scene = tie_scene(SceneBuilder)
        o, d, t = tie_rays(n, seed=64)
    o, d, t = _cuda(dev, o, d, t)
    valid = None
    if share is not None:
        g = torch.Generator(device=dev).manual_seed(65)
        valid = torch.rand(n, generator=g, device=dev) < share
    return scene.to(dev), o, d, t, mb, valid


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_closest_hit_kernel_equals_plain_on_every_lane(dev, case):
    """K1 against its fold over the type runs in plain torch
    (closest_hit_runs, the kernels' operation order) on every valid lane:
    object ids and t equal; against closest_hit_brute: hit, object and
    material ids equal on every valid lane but at most BUDGET of them (the
    rounding of torch's cross product at a triangle's edge; none with
    spheres alone or axis-aligned ties), t and normals within 1e-4 +
    1e-4 |x| where the ids
    agree.  A lane that is not valid reports a miss.  The cases: 102
    spheres (the Whitted frame's table) and 1,005 objects (the cost-brute
    route's, mostly triangles), all valid or sparse, each also under motion
    blur, more lanes than the card holds threads (a deep level of the
    staged tree), a ragged count, every sphere and triangle twice under
    motion blur, and exact ties whose lower id lies in a later type
    run."""
    scene, o, d, t, mb, valid = _k1_inputs(dev, case)
    tb = CI.object_tables(scene)
    _reset_launches()
    h = CI.closest_hit_kernel(scene, o, d, t, mb, valid=valid, tables=tb)
    torch.cuda.synchronize()
    assert _launches()[0] == 1
    v = torch.ones_like(h.hit) if valid is None else valid
    rt, rid = CI.closest_hit_runs(tb, o, d, t, mb)
    assert torch.equal(h.obj_id[v], rid[v])
    assert torch.equal(h.t[v], rt[v])
    assert torch.equal(h.hit[v], rid[v] >= 0)
    hit = v & (rid >= 0)
    assert 0.05 < float(hit.float().sum() / v.float().sum()) < 0.999
    assert torch.equal(h.mat_id[hit], tb.mats[rid[hit].long()])
    assert not h.hit[~v].any() and bool((h.obj_id[~v] == -1).all())
    assert bool((h.t[~v] == torch.finfo(torch.float32).max).all())
    assert not h.normal[~v].any() and not h.mat_id[~v].any()
    assert h.normal.is_contiguous() and h.normal.shape == (o.shape[0], 3)
    ref = closest_hit_brute(scene, o, d, t, mb)
    ids = v & ((ref.hit != h.hit) | (ref.obj_id != h.obj_id)
               | (ref.hit & (ref.mat_id != h.mat_id)))
    if case.startswith(("spheres", "ties-across")):
        assert not ids.any()
    assert float(ids.float().mean()) <= BUDGET
    same = v & ~ids & ref.hit
    near = lambda a, b: (a - b).abs() <= 1e-4 + 1e-4 * b.abs()
    assert bool(near(h.t, ref.t)[same].all())
    assert bool(near(h.normal, ref.normal).all(-1)[same].all())
    if case.startswith("ties-across-runs"):
        # the box (id 0) beats the triangle and the plane at t = 5, the
        # lower sphere (id 1) its copy (id 4)
        assert not bool((h.obj_id[v] == 4).any())
        assert bool((h.obj_id[v] == 0).any()) and bool(
            (h.obj_id[v] == 1).any())


def test_shading_does_not_depend_on_the_normal_layout(dev):
    """A tree level's shading gives the same outputs whether the hit's
    normal is contiguous (K1, K9, the plain versions) or the transposed
    (3, R) view the packet walks return: a sum over a strided axis rounds
    in another order on the card, and the ray trees of two routes that
    found the same hits then parted."""
    from distributionraytracer_tpu_torch.integrator.whitted import (
        _shade_node,
    )
    scene = prim_scene(SceneBuilder).to(dev)
    cfg = RenderConfig()
    o, d, t = _cuda(dev, *random_rays(N, seed=66))
    h = closest_hit_brute(scene, o, d, t, False)
    strided = h._replace(normal=h.normal.T.contiguous().T)
    assert not strided.normal.is_contiguous()
    inter = brute_intersectors(scene, cfg)
    args = (o, d, t, torch.ones(N, device=dev),
            torch.rand(N, 2, device=dev), torch.ones_like(h.hit))
    a = _shade_node(scene, cfg, inter, *args, h, spawn_children=True)
    b = _shade_node(scene, cfg, inter, *args, strided, spawn_children=True)
    torch.cuda.synchronize()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# K2 cases: the share of valid lanes (None: no valid input), a lane count
# that is not a multiple of the 256-lane blocks, every object listed twice
K2_CASES = {
    "valid-0%": {"valid": 0.0},
    "valid-0.5%": {"valid": 0.005},
    "valid-38%": {"valid": 0.38},
    "valid-100%": {"valid": 1.0},
    "no-valid-input": {"valid": None},
    "ragged": {"valid": 0.38, "n": N + 77},
    "twice": {"valid": 0.38, "twice": True},
}


def _k2_every_lane(scene, o, d, dist, ex, valid, mode, mb):
    """K2 against any_hit_brute and against its fold over the type runs,
    equal on every lane (an invalid lane: no occluder).  Returns the
    reference."""
    ref = any_hit_brute(scene, o, d, torch.zeros_like(dist), dist, ex, mb,
                        mode=mode)
    runs = CI.any_hit_runs(CI.object_tables(scene), o, d, dist, ex, mode)
    occ = CI.any_hit_kernel(scene, o, d, dist, ex, mb, mode=mode,
                            valid=valid)
    torch.cuda.synchronize()
    if valid is not None:
        ref, runs = ref & valid, runs & valid
    assert torch.equal(runs, ref)
    assert torch.equal(occ, ref)
    return ref


@pytest.mark.parametrize("case", sorted(K2_CASES))
@pytest.mark.parametrize("mb", [False, True], ids=["static", "motion"])
@pytest.mark.parametrize("mode", ["none", "grid", "bvh"])
def test_any_hit_kernel_matches_plain(dev, mode, mb, case):
    """K2 on the scene of every primitive type (every type run), in each
    mode, with and without motion blur (shadow rays carry time 0), at
    valid shares from none to all, equal to plain on every lane."""
    c = K2_CASES[case]
    scene = prim_scene(SceneBuilder, twice=c.get("twice", False)).to(dev)
    n = c.get("n", N)
    o, d, dist, ex = _cuda(dev, *occlusion_inputs(scene.static.n_objects, n,
                                                  71))
    share = c["valid"]
    valid = None if share is None else torch.from_numpy(
        np.random.default_rng(72).random(n) < share).to(dev)
    ref = _k2_every_lane(scene, o, d, dist, ex, valid, mode, mb)
    if share is None or share >= 0.3:
        assert 0.05 < float(ref.float().mean()) < 0.9


@pytest.mark.parametrize("mode", ["none", "grid", "bvh"])
def test_any_hit_kernel_lane_whose_only_occluder_is_excluded(dev, mode):
    """Lanes whose one occluder (in mode none) is their excluded object:
    unoccluded in mode none, occluded in the modes with no exclusion."""
    from distributionraytracer_tpu_torch.ops.intersect import _type_tmats
    scene = prim_scene(SceneBuilder).to(dev)
    o, d, dist, _ = _cuda(dev, *occlusion_inputs(scene.static.n_objects, N,
                                                 73))
    okm = torch.zeros((N, scene.static.n_objects), dtype=torch.bool,
                      device=dev)
    for _typ, gids, tm in _type_tmats(scene, o, d, torch.zeros_like(dist),
                                      False):
        okm[:, gids.long()] = (tm < dist[:, None]) & (tm > 1e-4)
    one = okm.sum(1) == 1
    assert float(one.float().mean()) > 0.05
    ex = torch.where(one, okm.float().argmax(1), -1).to(torch.int32)
    ref = _k2_every_lane(scene, o, d, dist, ex, None, mode, False)
    assert bool(ref[one].all()) if mode != "none" else not bool(
        ref[one].any())


@pytest.mark.parametrize("spawn", [True, False], ids=["spawn", "leaf"])
@pytest.mark.parametrize("shadow_mode", ["reference", "correct"])
def test_fused_level_kernel_matches_plain(dev, spawn, shadow_mode):
    scene = prim_scene(SceneBuilder).to(dev)
    cfg = RenderConfig(motion_blur=True, shadow_mode=shadow_mode)
    args = _cuda(dev, *level_inputs(N, seed=12))
    valid = args[-1]
    ref = CW.fused_level_plain(scene, cfg, *args, spawn=spawn)
    res = CW.fused_level_kernel(scene, cfg, *args, spawn=spawn)
    torch.cuda.synchronize()
    ref = {k: v.cpu().numpy() for k, v in ref.items()}
    compare_levels(ref, res, valid.cpu().numpy(), lane_budget=BUDGET)


def assert_images_close(img, ref, atol=3e-3, outlier_frac=0.005,
                        max_outlier=0.05):
    """The budget of tests/test_whitted.py::assert_images_close."""
    diff = (img - ref).abs()
    bad = float((diff > atol).float().mean())
    assert bad <= outlier_frac, bad
    assert float(diff.max()) <= max_outlier, float(diff.max())


def _reset_launches():
    CW.reset_launches()
    CI.reset_launches()


def _launches():
    return (CI.LAUNCHES["closest_hit"], CI.LAUNCHES["any_hit"],
            CW.LAUNCHES["fused_level"])


def _k3_kernels(run):
    """K3 kernels the card ran during ``run()``, counted in
    torch.profiler's device trace: a replayed tile graph launches them
    without a call of the launcher, which ``CW.LAUNCHES`` counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and "whitted_level_kernel" in e.name())


def _eager_tiles():
    """Within it, every frame runs its tiles eagerly: the reference the
    tile graphs are held to."""
    mode = RD._tile_mode

    def eager(*args):
        m = mode(*args)
        return "k3" if m == "graph" else m

    return mock.patch.object(RD, "_tile_mode", eager)


def _tiles(samples, cfg):
    return -(-samples.time.numel() // cfg.tile_rays)


def test_renderer_routes_match_on_card(dev):
    scene = create_random_scene(0, 64, 48)
    cfg = default_config(scene, spp=16)
    r = Renderer(scene, cfg, device=dev)
    assert r.executed_backend() == "fused-level"
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(0))
    levels = cfg.max_depth + 1
    _reset_launches()
    img, nrays = r.render_with_samples(samples, return_rays=True)
    torch.cuda.synchronize()
    assert _launches()[:2] == (0, 0) and _launches()[2] > 0
    assert _k3_kernels(lambda: r.render_with_samples(
        samples, return_rays=True)) == levels
    assert torch.isfinite(img).all() and float(img.std()) > 0.05
    _reset_launches()
    staged = render_from_samples(r.scene, cfg, samples, return_rays=True,
                                 inter=brute_intersectors(r.scene, cfg))
    torch.cuda.synchronize()
    assert _launches() == (levels, levels, 0)
    off = Renderer(scene, cfg.replace(kernels="off"), device=dev)
    plain = off.render_with_samples(samples, return_rays=True)
    assert _launches() == (levels, levels, 0)
    for ref, ref_rays in (staged, plain):
        assert_images_close(img, ref)
        assert abs(int(nrays) - int(ref_rays)) <= COUNT_BUDGET * int(nrays)


def test_kernels_take_scenes_past_1024_objects(dev):
    scene = crowd_scene(SceneBuilder)
    cfg = RenderConfig(spp=2)
    r = Renderer(scene, cfg, device=dev)
    assert r.executed_backend() == "fused-level"
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(0))
    _reset_launches()
    img = r.render_with_samples(samples)
    torch.cuda.synchronize()
    assert _launches()[:2] == (0, 0) and _launches()[2] > 0
    assert _k3_kernels(lambda: r.render_with_samples(samples)) == (
        _tiles(samples, cfg) * (cfg.max_depth + 1))
    plain = Renderer(scene, cfg.replace(kernels="off"), device=dev)
    assert_images_close(img, plain.render_with_samples(samples))
    o, d, t = _cuda(dev, *random_rays(N, seed=8))
    ref = closest_hit_brute(r.scene, o, d, t, False)
    h = CI.closest_hit(r.scene, o, d, t, False)
    assert _launches()[0] == 1
    assert 0.05 < float(ref.hit.float().mean())
    assert _mismatch(ref.obj_id, h.obj_id) <= BUDGET


# --------------------------- K3's compacted lanes, ties and large tables
def _level_vs_plain(scene, cfg, args, spawn, grid_bbox=None):
    ref = CW.fused_level_plain(scene, cfg, *args, spawn=spawn,
                               grid_bbox=grid_bbox)
    res = CW.fused_level_kernel(scene, cfg, *args, spawn=spawn,
                                grid_bbox=grid_bbox)
    torch.cuda.synchronize()
    ref = {k: v.cpu().numpy() for k, v in ref.items()}
    compare_levels(ref, res, args[-1].cpu().numpy(), lane_budget=BUDGET)


def _scene_box(scene):
    """A grid box around the scene's bounded objects, for K3's grid mode
    on an accel-NONE scene."""
    return (np.array([-5, -2, -5], np.float32),
            np.array([5, 3, 5], np.float32))


@pytest.mark.parametrize("kind", ["prim", "crowd"])
@pytest.mark.parametrize("grid", [False, True], ids=["none", "grid"])
def test_fused_level_kernel_sparse_valid_lanes(dev, kind, grid):
    """K3 where 3% of the lanes are valid, scattered (the deep levels'
    shape), spawn on and off, in both modes: on the four-primitive scene
    and on the 1,100-object scene."""
    builder = prim_scene if kind == "prim" else crowd_scene
    scene = builder(SceneBuilder).to(dev)
    cfg = RenderConfig(motion_blur=True)
    o, d, t, ior, ls, _ = _cuda(dev, *level_inputs(N, seed=50))
    valid = torch.from_numpy(np.random.default_rng(51).random(N) < 0.03)
    valid = valid.to(dev)
    assert 0.02 < float(valid.float().mean()) < 0.04
    gb = _scene_box(scene) if grid else None
    for spawn in (True, False):
        _level_vs_plain(scene, cfg, [o, d, t, ior, ls, valid], spawn, gb)


def test_fused_level_kernel_large_table_all_lanes(dev):
    """K3 on every lane of the 1,100-object scene, both modes and both
    shadow modes, with the fused-level budgets."""
    scene = crowd_scene(SceneBuilder).to(dev)
    args = _cuda(dev, *level_inputs(N, seed=54))
    args[-1] = torch.ones_like(args[-1])
    for gb in (None, _scene_box(scene)):
        for mode in ("reference", "correct"):
            _level_vs_plain(scene, RenderConfig(shadow_mode=mode), args,
                            True, gb)


def test_fused_level_kernel_no_valid_lane(dev):
    """K3 with no valid lane writes zero to every output row of every
    lane (the output starts as NaN)."""
    scene = prim_scene(SceneBuilder).to(dev)
    o, d, t, ior, ls, _ = _cuda(dev, *level_inputs(N, seed=52))
    tb = CW.level_tables(scene)
    rays = CI.ray_streams(N, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                          d[:, 2], t, ior, ls[:, 0], ls[:, 1],
                          torch.zeros(N, device=dev))
    for spawn, rows in ((True, 29), (False, 4)):
        out = torch.full((rows, N), float("nan"), device=dev)
        CW.launch_level(tb, scene.static.n_objects, rays, RenderConfig(),
                        spawn, out)
        torch.cuda.synchronize()
        assert bool((out == 0).all())


@pytest.mark.parametrize("grid", [False, True], ids=["none", "grid"])
def test_level_and_closest_kernels_ties_take_lower_id(dev, grid):
    """Every sphere and triangle listed twice, the copies later and in
    other materials: K3 equals its plain version (a copy's material would
    show in the colour and the children), and K1 never returns a copy's
    id, which would be a tie won by the higher id."""
    scene = prim_scene(SceneBuilder, ties=True).to(dev)
    args = _cuda(dev, *level_inputs(N, seed=53))
    _level_vs_plain(scene, RenderConfig(), args, True,
                    _scene_box(scene) if grid else None)
    o, d, t = args[:3]
    ref = closest_hit_brute(scene, o, d, t, False)
    h = CI.closest_hit_kernel(scene, o, d, t, False)
    torch.cuda.synchronize()
    tied = torch.isin(ref.obj_id, torch.tensor([0, 2, 4, 5], device=dev))
    assert float(tied.float().mean()) > 0.03
    copies = torch.tensor([8, 9, 10, 11], device=dev)
    assert not bool(torch.isin(h.obj_id, copies).any())
    assert _mismatch(ref.obj_id, h.obj_id) <= BUDGET
    assert _mismatch(ref.mat_id[ref.hit], h.mat_id[ref.hit]) <= BUDGET


# ---------------------------------------------------------- path tracer
def _pt_scene(dev, si):
    args = () if si == 0 else synthetic_faces(si)
    return SCENE_BUILDERS[si](*args).to(dev)


@pytest.mark.parametrize("si", [0, 3])
def test_pt_query_kernels_match_plain(dev, si):
    """K4 and K5 against hit_world / any_hit: hit and material equal, t to
    rtol 2e-4, normals beyond 1e-3 on under 0.5% of the hits; at most
    BUDGET of the lanes may flip at the measure-zero edges."""
    scene = _pt_scene(dev, si)
    o, d, tm = random_rays(N, seed=20 + si, spread=5.0)
    if si == 3:  # origins inside the open Cornell box
        o = np.random.default_rng(si).uniform((-12, -12, 15), (12, 12, 25),
                                              (N, 3))
    o, d, tm = _cuda(dev, o.astype(np.float32), d, tm)
    ref = PT.hit_world(scene, o, d, tm)
    h = CP.pt_closest_kernel(scene, o, d, tm)
    torch.cuda.synchronize()
    assert 0.05 < float(ref.hit.float().mean()) < 0.95
    same = (ref.hit == h.hit) & (~ref.hit | (ref.mat == h.mat))
    both = same & ref.hit
    near = (h.t - ref.t).abs() <= 2e-4 * ref.t.abs()
    assert float((~same | (both & ~near)).float().mean()) <= BUDGET
    dn = (h.normal - ref.normal).abs().amax(-1) > 1e-3
    assert float(dn[both].float().mean()) < 0.005
    tmax = torch.rand(N, device=dev) * 20 + 0.5
    ref_occ = PT.any_hit(scene, o, d, tm, 1e-3, tmax)
    occ = CP.pt_any_hit_kernel(scene, o, d, tm, tmax)
    torch.cuda.synchronize()
    assert 0.05 < float(ref_occ.float().mean()) < 0.95
    assert _mismatch(ref_occ, occ) <= BUDGET


@pytest.mark.parametrize("si", [0, 1, 2, 3, 4])
def test_pt_any_hit_kernel_equals_plain_on_every_lane(dev, si):
    """K5 against pathtracer.any_hit on every lane of each GLSL scene:
    moving spheres at times in [0, 1), tmax at or below the 1e-3 tmin on a
    tenth of the lanes (no occluder there), a ragged lane count, and one
    tmax for every lane."""
    scene = _pt_scene(dev, si)
    eye, lo, hi = PT_VIEWS[si]
    n = N + 77
    rng = np.random.default_rng(80 + si)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    _, d, tm = pt_rays(n, 81 + si, eye, lo, hi)
    tmax = rng.uniform(0.0, 20.0, n).astype(np.float32)
    low = rng.random(n) < 0.1
    tmax[low] = rng.uniform(-1e-3, 1e-3, int(low.sum()))
    o, d, tm, tmax, low = _cuda(dev, o, d, tm, tmax, low)
    ref = PT.any_hit(scene, o, d, tm, 1e-3, tmax)
    occ = CP.pt_any_hit_kernel(scene, o, d, tm, tmax)
    torch.cuda.synchronize()
    assert torch.equal(occ, ref)
    assert not bool(ref[low].any())
    if scene.tri_v0.shape[0] + scene.sph_center.shape[0] > 4:
        assert 0.05 < float(ref[~low].float().mean()) < 0.95
    ref5 = PT.any_hit(scene, o, d, tm, 1e-3, torch.full_like(tmax, 5.0))
    assert torch.equal(CP.pt_any_hit_kernel(scene, o, d, tm, 5.0), ref5)


def _pt_own_materials(dev, si, ties=False):
    """Scene si with each primitive in a material of its own (a hit's
    material is the winner's index); ``ties``: every triangle and sphere
    listed twice first."""
    base = _pt_scene(dev, si)
    leaves = {n: getattr(base, n).cpu().numpy() for n in PS.PTScene._LEAVES}
    if ties:
        leaves = pt_tie_leaves(leaves)
    return PS.pt_scene_from_numpy(pt_own_material_leaves(leaves),
                                  base.sky_mode).to(dev)


@pytest.mark.parametrize("si", [0, 1, 2, 3, 4])
def test_pt_closest_kernel_equals_plain_on_every_lane(dev, si):
    """K4 against pathtracer.hit_world on every lane of each GLSL scene,
    each primitive in a material of its own, so the material names the
    winner: origins at the view's eye and spread over its box, moving
    spheres at times in [0, 1), a ragged lane count.  Hit, winner and
    position's hit flag equal on every lane; t to rtol 1e-5 and normals to
    1e-4 on every hit lane (test_pt_query_kernels_match_plain allows rtol
    2e-4, and normals beyond 1e-3 on 0.5% of the hits)."""
    scene = _pt_own_materials(dev, si)
    eye, lo, hi = PT_VIEWS[si]
    n = N + 77
    rng = np.random.default_rng(90 + si)
    o, d, tm = pt_rays(n, 91 + si, eye, lo, hi)
    half = rng.random(n) < 0.5
    o[half] = rng.uniform(lo, hi, (int(half.sum()), 3))
    o, d, tm = _cuda(dev, o.astype(np.float32), d, tm)
    ref = PT.hit_world(scene, o, d, tm)
    h = CP.pt_closest_kernel(scene, o, d, tm)
    torch.cuda.synchronize()
    assert 0.05 < float(ref.hit.float().mean())
    assert torch.equal(h.hit, ref.hit)
    assert torch.equal(h.mat, ref.mat)
    hit = ref.hit
    assert bool(((h.t - ref.t).abs() <= 1e-5 * ref.t.abs())[hit].all())
    assert bool(torch.equal(h.t[~hit], ref.t[~hit]))
    assert float((h.normal - ref.normal).abs()[hit].max()) <= 1e-4
    assert torch.equal(h.normal[~hit], ref.normal[~hit])
    assert float((h.pos - ref.pos).abs().max()) <= 1e-4 * max(
        1.0, float(ref.pos.abs().max()))


@pytest.mark.parametrize("si", [0, 3])
def test_pt_closest_kernel_ties_take_the_lower_index(dev, si):
    """K4 with every triangle and sphere listed twice (each in a material
    of its own): every hit on one is an exact tie in t, which the lower
    index, the original, wins, as in hit_world."""
    scene = _pt_own_materials(dev, si, ties=True)
    o, d, tm = _cuda(dev, *pt_rays(N, 95 + si, *PT_VIEWS[si]))
    ref = PT.hit_world(scene, o, d, tm)
    h = CP.pt_closest_kernel(scene, o, d, tm)
    torch.cuda.synchronize()
    assert float(ref.hit.float().mean()) > 0.3
    assert torch.equal(h.hit, ref.hit) and torch.equal(h.mat, ref.mat)
    T2, S2 = scene.tri_v0.shape[0], scene.sph_center.shape[0]
    m = h.mat.long()[h.hit]
    copy = ((m >= T2 // 2) & (m < T2)) | ((m >= T2 + S2 // 2) & (m < T2 + S2))
    assert not bool(copy.any())


def _bounce_lanes_off(ref, got):
    """K6 states that differ per lane: alive flags, origins beyond 1e-5 of
    their magnitude, any other row beyond atol 2e-3 + rtol 2e-3."""
    off = (ref[CP.ST_ALIVE] > 0) != (got[CP.ST_ALIVE] > 0)
    o_lim = 1e-5 * torch.clamp(ref[CP.ST_O].abs().amax(0), min=1.0)
    off |= ~((got[CP.ST_O] - ref[CP.ST_O]).abs() <= o_lim).all(0)
    rest = ref[3:]
    off |= ~((got[3:] - rest).abs() <= 2e-3 + 2e-3 * rest.abs()).all(0)
    return off


@pytest.mark.parametrize("si", [0, 1, 2, 3, 4])
def test_pt_bounce_kernel_matches_plain(dev, si):
    """K6 against its plain version, one bounce from camera rays and one
    from the plain state after three bounces, on the same uniforms, in
    every scene: all four materials, point and quad lights, gradient and
    cubemap skies."""
    scene = _pt_scene(dev, si)
    o, d, tm = _cuda(dev, *pt_rays(N, 30 + si, *PT_VIEWS[si]))
    n_ql = scene.qlight_pos.shape[0]
    g = torch.Generator(device=dev).manual_seed(si)
    state = CP.bounce_state(o, d, tm)
    for b in range(4):
        u = PT.draw_uniforms(scene, N, g, dev)
        uni = CP.bounce_streams(u.uch, u.u3a, u.u3b, u.urr, u.uq, n_ql)
        if b in (0, 3):
            got = CP.pt_bounce_kernel(scene, state.clone(), uni, True)
            ref = CP.pt_bounce_plain(scene, state.clone(), uni, True)
            torch.cuda.synchronize()
            assert 0 < int((ref[CP.ST_ALIVE] > 0).sum()) < N
            assert float(_bounce_lanes_off(ref, got).float().mean()) <= \
                BUDGET
        CP.pt_bounce_plain(scene, state, uni, True)


def _pt_variant(dev, kind):
    """Scene 0, as it is, with every triangle and sphere listed twice
    (``ties``), or with 1,000 small spheres (``crowd``)."""
    base = _pt_scene(dev, 0)
    if kind == "scene0":
        return base
    leaves = {n: getattr(base, n).cpu().numpy() for n in PS.PTScene._LEAVES}
    fn = pt_tie_leaves if kind == "ties" else pt_crowd_leaves
    return PS.pt_scene_from_numpy(fn(leaves), base.sky_mode).to(dev)


@pytest.mark.parametrize("kind", ["scene0", "ties", "crowd"])
def test_pt_bounce_kernel_sparse_live_lanes(dev, kind):
    """K6 against its plain version with every path alive, with 3% alive
    (scattered: the late bounces' shape), and with none (the state passes
    through with its time cleared), on scene 0, on scene 0 with tied
    copies (the lower index's material must win; K4's materials too) and
    on 1,000 small spheres (a table ten times scene 0's)."""
    scene = _pt_variant(dev, kind)
    o, d, tm = _cuda(dev, *pt_rays(N, 60, *PT_VIEWS[0]))
    g = torch.Generator(device=dev).manual_seed(60)
    u = PT.draw_uniforms(scene, N, g, dev)
    uni = CP.bounce_streams(u.uch, u.u3a, u.u3b, u.urr, u.uq,
                            scene.qlight_pos.shape[0])
    state = CP.bounce_state(o, d, tm)
    for share in (1.0, 0.03, 0.0):
        st = state.clone()
        st[CP.ST_ALIVE] = (torch.rand(N, generator=g, device=dev)
                           < share).float()
        got = CP.pt_bounce_kernel(scene, st.clone(), uni, True)
        ref = CP.pt_bounce_plain(scene, st.clone(), uni, True)
        torch.cuda.synchronize()
        assert float(_bounce_lanes_off(ref, got).float().mean()) <= BUDGET
        if share == 0.0:
            st[CP.ST_TIME] = 0.0
            assert torch.equal(got, st)
    if kind == "ties":
        ref = PT.hit_world(scene, o, d, tm)
        h = CP.pt_closest_kernel(scene, o, d, tm)
        torch.cuda.synchronize()
        assert float(ref.hit.float().mean()) > 0.3
        same = (ref.hit == h.hit) & (~ref.hit | (ref.mat == h.mat))
        assert float((~same).float().mean()) <= BUDGET


@pytest.mark.parametrize("si", [0, 3])
def test_pt_scene_without_primitives_launches_kernels(dev, si):
    """A scene with no primitive runs K6 on the fused route and K4/K5 on
    the staged one, like any other, and matches the plain route: every
    path sees the sky at once."""
    full = _pt_scene(dev, si)
    scene = dataclasses.replace(
        full, **{n: getattr(full, n)[:0] for n in PT_PRIM_LEAVES})
    cfg = RenderConfig(max_bounces=3)
    run = lambda c, q=None: PT.render_pt(
        scene, c, 16, 12, torch.Generator(device=dev).manual_seed(1),
        spp=2, queries=q)
    CP.reset_launches()
    fused = run(cfg)
    torch.cuda.synchronize()
    assert CP.LAUNCHES == {"pt_closest": 0, "pt_any_hit": 0, "pt_bounce": 0,
                           "pt_trace": 1}
    CP.reset_launches()
    staged = run(cfg, PT.kernel_queries(scene))
    torch.cuda.synchronize()
    n_pl = scene.plight_pos.shape[0]
    assert CP.LAUNCHES == {"pt_closest": 3, "pt_any_hit": 3 * n_pl,
                           "pt_bounce": 0, "pt_trace": 0}
    plain = run(cfg.replace(kernels="off"))
    assert float(plain.min()) > 0.0
    for img in (fused, staged):
        torch.testing.assert_close(img, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("si", [0, 3])
def test_pt_routes_match_plain_on_card(dev, si):
    """A small frame on the fused route (K6 only) and the staged kernel
    route (K4 and K5 only) against the plain staged route, on injected
    uniforms, with the statistic of test_pallas_pt."""
    scene = _pt_scene(dev, si)
    W, H, S, B = 32, 24, 4, 6
    eye, at = ([6, 1.6, -6], [0, 0.5, 0]) if si == 0 else (
        [0, -3, -6], [0, -3, 10])
    g = torch.Generator(device=dev).manual_seed(7)
    R = W * H * S
    nq = max(scene.qlight_pos.shape[0], 1)
    samples = PT.PTSamples(
        torch.rand((H, W, S, 2), generator=g, device=dev),
        torch.rand((H, W, S), generator=g, device=dev),
        PT.BounceUniforms(*(torch.rand((B,) + sh, generator=g, device=dev)
                            for sh in ((R, 2 * nq), (R,), (R, 3), (R, 3),
                                       (R,)))))
    cfg = RenderConfig(max_bounces=B, pt_tile_rays=1024)
    run = lambda c, q=None: PT.render_pt(scene, c, W, H, eye=eye, at=at,
                                         spp=S, samples=samples, queries=q)
    CP.reset_launches()
    fused = run(cfg)
    torch.cuda.synchronize()
    tiles = -(-R // cfg.pt_tile_rays)
    # injected uniforms: one looped K6 launch over every tile's paths
    assert CP.LAUNCHES == {"pt_closest": 0, "pt_any_hit": 0,
                           "pt_bounce": 0, "pt_trace": 1}
    CP.reset_launches()
    staged = run(cfg, PT.kernel_queries(scene))
    torch.cuda.synchronize()
    n_pl = scene.plight_pos.shape[0]
    assert CP.LAUNCHES == {"pt_closest": tiles * B,
                           "pt_any_hit": tiles * B * n_pl, "pt_bounce": 0,
                           "pt_trace": 0}
    CP.reset_launches()
    plain = run(cfg.replace(kernels="off"))
    assert CP.LAUNCHES == {"pt_closest": 0, "pt_any_hit": 0, "pt_bounce": 0,
                           "pt_trace": 0}
    assert float(plain.std()) > 0.02
    for img in (fused, staged):
        assert torch.isfinite(img).all()
        assert float(((img - plain).abs() > 1e-3).float().mean()) < 0.05
        assert abs(float(img.mean() - plain.mean())) < 5e-3


# -------------------------------------------- accel: K7, K8, K9, K10, K3 grid
from distributionraytracer_tpu_torch.accel import cuda_binned as CBN  # noqa: E402
from distributionraytracer_tpu_torch.accel import cuda_bvh as CBV  # noqa: E402
from distributionraytracer_tpu_torch.accel.bvh import (  # noqa: E402
    build_bvh, collapse_leaves, protect_mask, thread_bvh, threaded_walk,
)
from distributionraytracer_tpu_torch.accel.cuda_packet import (  # noqa: E402
    GROUPED_LEAF, pack_grouped,
)
from distributionraytracer_tpu_torch.integrator.render import (  # noqa: E402
    _block_perm, _rays_from_samples,
)
from distributionraytracer_tpu_torch.scene.types import (  # noqa: E402
    ACCEL_BVH, ACCEL_GRID,
)

from torch_scenes import (  # noqa: E402
    accel_rays, first_entry_batch, mesh_scene, scattered_shadow_batch,
    stacked_scene,
)

MESH_TRI = 20_000  # the card tests' mesh; the smoke run takes 100,000
SMALL_TRI = 600  # <= 1024 objects without a plane: the cost-brute route


def _mesh(accel, n_tri=MESH_TRI, res=(128, 128)):
    return mesh_scene(SceneBuilder, n_tri=n_tri, accel=accel, res=res)


def _accel_reset():
    for m in (CI, CW, CBV, CBN):
        m.reset_launches()


def _accel_launches():
    return {"K1": CI.LAUNCHES["closest_hit"], "K2": CI.LAUNCHES["any_hit"],
            "K3": CW.LAUNCHES["fused_level"],
            "K3grid": CW.LAUNCHES["fused_level_grid"],
            "K7": CBV.LAUNCHES["grouped_closest"]
            + CBV.LAUNCHES["grouped_shadow"],
            "K8": CBV.LAUNCHES["legacy_closest"]
            + CBV.LAUNCHES["legacy_shadow"],
            "K9": CBN.LAUNCHES["binned_closest"],
            "K10": CBN.LAUNCHES["binned_shadow"]}


def _packet_tables(scene, kind):
    tb = thread_bvh(build_bvh(scene))
    prot = protect_mask(scene)
    if kind == "grouped":
        return pack_grouped(scene, collapse_leaves(tb, GROUPED_LEAF,
                                                   protect=prot))
    return CBV.pack_threaded(scene, collapse_leaves(tb, CBV.PACKET_LEAF,
                                                    protect=prot))


@pytest.mark.parametrize("kind", ["grouped", "threaded"], ids=["K7", "K8"])
def test_packet_kernels_match_plain_walk(dev, kind):
    """K7 and K8 against the plain threaded walk on their own tables: hit
    masks and object ids equal on every valid lane, t and normals within
    1e-5 relative; the occlusion of both shadow modes equal."""
    scene = _mesh(ACCEL_BVH)
    tabs = _packet_tables(scene, kind)
    assert tabs is not None and tabs.kind == kind
    tabs, sc = tabs.to(dev), scene.to(dev)
    o, d, dist, valid = _cuda(dev, *accel_rays(N, seed=40))
    tm = torch.zeros(N, device=dev)
    types = tuple(sorted(set(scene.static.obj_types)))
    _accel_reset()
    t, n, gid = CBV.packet_closest_kernel(tabs, o, d, tm, valid)
    rt, rn, rid = threaded_walk(tabs, o, d, tm, valid, types_present=types)
    torch.cuda.synchronize()
    hit = rid >= 0
    assert 0.3 < float(hit[valid].float().mean()) < 0.99
    assert torch.equal(gid[valid], rid[valid])
    assert not (gid[~valid] >= 0).any()
    torch.testing.assert_close(t[hit], rt[hit], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(n[hit], rn[hit], rtol=1e-5, atol=1e-5)
    for mode in ("bvh", "grid"):
        occ = CBV.packet_shadow_kernel(tabs, o, d, dist, valid,
                                       shadow_mode=mode)
        ref = threaded_walk(tabs, o, d, None, valid, shadow_dist=dist,
                            shadow_mode=mode, types_present=types)
        torch.cuda.synchronize()
        assert 0.05 < float(ref[valid].float().mean()) < 0.95
        assert torch.equal(occ[valid], ref[valid])
    name = "K7" if kind == "grouped" else "K8"
    assert _accel_launches()[name] == 3


# K7/K8 walk cases: the share of live lanes, the lane count (not a
# multiple of the 256-lane blocks), every triangle and sphere twice, motion
# blur, the grid emulation's tree
WALK_CASES = {
    "live-0.5%": {"live": 0.005},
    "live-38%": {"live": 0.38},
    "live-100%": {"live": 1.0},
    "no-live": {"live": 0.0},
    "ragged": {"live": 0.38, "n": N + 77},
    "ties": {"live": 0.38, "twice": True},
    "motion": {"live": 0.38, "motion": True},
    "grid": {"live": 0.38, "accel": ACCEL_GRID},
}
WALK_TRI = 10_000


@pytest.mark.parametrize("case", sorted(WALK_CASES))
@pytest.mark.parametrize("kind", ["grouped", "threaded"], ids=["K7", "K8"])
def test_packet_walks_equal_plain_on_every_lane(dev, kind, case):
    """K7 and K8 on the route's own tables against the plain walk: object
    ids, and the occlusion of both shadow modes, equal on every lane (dead
    lanes too); t and normals within 1e-5 relative on the hits."""
    c = WALK_CASES[case]
    accel, mb = c.get("accel", ACCEL_BVH), c.get("motion", False)
    scene = mesh_scene(SceneBuilder, n_tri=WALK_TRI, accel=accel,
                       res=(64, 64), twice=c.get("twice", False))
    cfg = RenderConfig(spp=0, motion_blur=mb, packet_kernel=(
        "grouped" if kind == "grouped" else "legacy"))
    r = Renderer(scene, cfg, device=dev)
    tabs = r.tabs.tabs if accel == ACCEL_GRID else r.tabs
    assert tabs.kind == kind
    n = c.get("n", N)
    o, d, dist, _ = accel_rays(n, seed=60)
    rng = np.random.default_rng(61)
    valid = rng.random(n) < c["live"]
    tm = (rng.random(n) if mb else np.zeros(n)).astype(np.float32)
    o, d, dist, valid, tm = _cuda(dev, o, d, dist, valid, tm)
    types = tuple(sorted(set(scene.static.obj_types)))
    _accel_reset()
    t, nrm, gid = CBV.packet_closest_kernel(tabs, o, d, tm, valid, mb)
    rt, rn, rid = threaded_walk(tabs, o, d, tm, valid, motion_blur=mb,
                                types_present=types)
    torch.cuda.synchronize()
    assert torch.equal(gid, rid)
    hit = rid >= 0
    assert bool((t[~hit] == rt[~hit]).all())
    torch.testing.assert_close(t[hit], rt[hit], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(nrm[hit], rn[hit], rtol=1e-5, atol=1e-5)
    if c["live"] >= 0.3:
        assert float(hit[valid].float().mean()) > 0.5
    if c.get("twice"):  # no copy wins a tie: the lower slot does
        assert not bool((gid >= scene.static.n_objects // 2).any())
    for mode in ("bvh", "grid"):
        occ = CBV.packet_shadow_kernel(tabs, o, d, dist, valid, mb,
                                       shadow_mode=mode)
        ref = threaded_walk(tabs, o, d, None, valid, shadow_dist=dist,
                            shadow_mode=mode, motion_blur=mb,
                            types_present=types)
        torch.cuda.synchronize()
        assert torch.equal(occ, ref)
        if c["live"] >= 0.3:
            assert 0.2 < float(ref[valid].float().mean()) < 0.9
    name = "grouped" if kind == "grouped" else "legacy"
    assert CBV.LAUNCHES[name + "_closest"] == 1
    assert CBV.LAUNCHES[name + "_shadow"] == 2


def test_binned_kernel_matches_plain(dev):
    """K9 against its plain stream of the same candidate lists (ids equal,
    t within 1e-5 relative) and against the packet walk of the whole
    tree: the binned winners differ only at exact ties (the reference's
    budget, <= 0.2% of lanes)."""
    scene = _mesh(ACCEL_BVH)
    cfg = RenderConfig(spp=0)
    r = Renderer(scene, cfg, device=dev)
    H, W = scene.static.res_y, scene.static.res_x
    bins = r._bins_for(H, W, 1)
    assert bins is not None
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(2))
    o, d, t, _ = _rays_from_samples(r.scene, cfg, samples)
    perm = torch.as_tensor(_block_perm(H, W, 1), device=dev).long()
    o, d, t = o[perm], d[perm], t[perm]
    valid = torch.rand(o.shape[0], device=dev) < 0.95
    _accel_reset()
    kt, kn, kid = CBN.binned_closest_kernel(r.tabs, bins.primary, o, d, t,
                                            valid)
    torch.cuda.synchronize()
    assert _accel_launches()["K9"] == 1
    stats = {}
    pt, pn, pid = CBN.binned_closest_plain(r.tabs, bins.primary, o, d, t,
                                           valid, stats=stats)
    assert stats["groups"] > 0
    hit = pid >= 0
    assert 0.2 < float(hit[valid].float().mean())
    assert torch.equal(kid[valid], pid[valid])
    torch.testing.assert_close(kt[hit], pt[hit], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(kn[hit], pn[hit], rtol=1e-5, atol=1e-5)
    _, _, wid = CBV.packet_closest_kernel(r.tabs, o, d, t, valid)
    assert float((wid != kid)[valid].float().mean()) <= 0.002


def test_fused_level_grid_mode_matches_plain(dev):
    """K3 in grid mode against fused_level_plain(grid_bbox=) on a grid
    scene, with the fused-level comparison's budgets."""
    scene = _mesh(ACCEL_GRID, n_tri=SMALL_TRI)
    r = Renderer(scene, RenderConfig(spp=0), device=dev)
    gb = (r.tabs.bbox_min, r.tabs.bbox_max)
    o, d, t, ior, ls, valid = _cuda(dev, *level_inputs(N, seed=41))
    o = o * 0.6 + torch.tensor([0.0, 1.4, 0.0], device=dev)
    for spawn in (True, False):
        cfg = RenderConfig(shadow_mode="reference")
        args = (o, d, t, ior, ls, valid)
        ref = CW.fused_level_plain(r.scene, cfg, *args, spawn=spawn,
                                   grid_bbox=gb)
        _accel_reset()
        res = CW.fused_level_kernel(r.scene, cfg, *args, spawn=spawn,
                                    grid_bbox=gb)
        torch.cuda.synchronize()
        assert _accel_launches()["K3grid"] == 1
        assert 0.1 < float(ref["_hit"][valid].float().mean()) < 0.9
        ref = {k: v.cpu().numpy() for k, v in ref.items()}
        compare_levels(ref, res, valid.cpu().numpy(), lane_budget=BUDGET)


ROUTES = {
    # label: (accel, n_tri, config overrides, kernels that must launch)
    "binned-primary+grouped-packet": (ACCEL_BVH, MESH_TRI, {},
                                      ("K7", "K9")),
    "binned-primary+grid-packet": (ACCEL_GRID, MESH_TRI, {}, ("K7", "K9")),
    "legacy-packet": (ACCEL_BVH, MESH_TRI, {"packet_kernel": "legacy"},
                      ("K8",)),
    "cost-brute-bvh": (ACCEL_BVH, SMALL_TRI, {}, ("K1", "K2")),
    "cost-brute-grid": (ACCEL_GRID, SMALL_TRI, {}, ("K1", "K2")),
}


@pytest.mark.parametrize("label", sorted(ROUTES))
def test_accel_routes_launch_their_kernels(dev, label):
    """Each accelerated route launches exactly its kernels (K9 once, on the
    primary level, where the frame is binned) and renders what its plain
    versions render on the same route."""
    accel, n_tri, over, expect = ROUTES[label]
    scene = _mesh(accel, n_tri=n_tri)
    cfg = RenderConfig(spp=0).replace(**over)
    r = Renderer(scene, cfg, device=dev)
    assert r.executed_backend() == label.replace("-bvh", "").replace(
        "-grid", "")
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(3))
    _accel_reset()
    img, nrays = r.render_with_samples(samples, return_rays=True)
    torch.cuda.synchronize()
    got = _accel_launches()
    assert {k for k, v in got.items() if v} == set(expect), got
    if "K9" in expect:
        assert got["K9"] == 1
    assert torch.isfinite(img).all() and float(img.std()) > 0.05
    plain = Renderer(scene, cfg.replace(kernels="off"), device=dev)
    _accel_reset()
    ref, ref_rays = plain.render_with_samples(samples, return_rays=True)
    assert not any(_accel_launches().values())
    assert_images_close(img, ref)
    assert abs(int(nrays) - int(ref_rays)) <= COUNT_BUDGET * int(nrays)


def test_fused_grid_level_route(dev):
    """render_from_samples(fused_grid=) runs every level on K3 in grid
    mode, and matches the cost-brute grid route's image."""
    scene = _mesh(ACCEL_GRID, n_tri=SMALL_TRI)
    cfg = RenderConfig(spp=0)
    r = Renderer(scene, cfg, device=dev)
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(4))
    gb = (r.tabs.bbox_min, r.tabs.bbox_max)
    _accel_reset()
    img = render_from_samples(r.scene, cfg, samples, fused_grid=gb)
    torch.cuda.synchronize()
    got = _accel_launches()
    assert got["K3grid"] == cfg.max_depth + 1
    assert sum(got.values()) == got["K3grid"]
    assert_images_close(img, r.render_with_samples(samples))


@pytest.mark.parametrize("accel", [ACCEL_BVH, ACCEL_GRID], ids=["bvh", "grid"])
def test_fallback_leaf_tree_takes_k8(dev, accel):
    """A tree with a fallback leaf of 150 objects, which the JAX package
    walks by XLA, renders on K8 (and nothing else) on the card, as its
    plain version renders it."""
    scene = stacked_scene(SceneBuilder, accel)
    cfg = RenderConfig(spp=0, accel_cost_threshold=0)
    r = Renderer(scene, cfg, device=dev)
    assert r.tabs is not None
    assert r.executed_backend() == ("legacy-packet" if accel == ACCEL_BVH
                                    else "grid-packet")
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(5))
    _accel_reset()
    img = r.render_with_samples(samples)
    torch.cuda.synchronize()
    got = _accel_launches()
    assert got["K8"] > 0 and sum(got.values()) == got["K8"], got
    plain = Renderer(scene, cfg.replace(kernels="off"), device=dev)
    assert_images_close(img, plain.render_with_samples(samples))


# ------------------------------------------------------ K10: binned shadows
BINNED_PLUS = {ACCEL_BVH: "grouped-packet", ACCEL_GRID: "grid-packet"}


def _box_mesh(accel, n_tri=MESH_TRI, res=(128, 128)):
    """The mesh scene with its finite ground: the light bins build."""
    return mesh_scene(SceneBuilder, n_tri=n_tri, accel=accel, res=res,
                      ground="box")


def _first_shadow(r, samples):
    """The inputs of the first shadow query of ``r``'s frame (the primary
    level's: 3 lights x H*W lanes)."""
    plan = r._plan(samples)
    inter = plan.inter
    log = []

    def shadow(o, d, dist, exclude_obj, valid=None):
        if not log:
            log.append((o, d, dist, valid))
        return inter.shadow(o, d, dist, exclude_obj, valid=valid)

    render_from_samples(r.scene, r.cfg, samples, plan=plan._replace(
        inter=Intersectors(inter.closest, shadow)))
    return plan.bins, log[0]


@pytest.mark.parametrize("accel", [ACCEL_BVH, ACCEL_GRID], ids=["bvh", "grid"])
def test_binned_shadow_kernel_matches_plain(dev, accel, monkeypatch):
    """K10 against its plain version on the primary shadow batch of its own
    route (bvh or grid shadow mode, the renderer's LIGHT_K bins): occlusion
    equal on every lane; against the packet walk of the whole tree the
    occlusion is the same function (at most 0.2% of lanes may differ: an
    origin's bins cover the segment to the light, which the offset ray
    misses by up to OFFSET)."""
    monkeypatch.setattr(CBN, "SHADOW_BINNING", True)
    scene = _box_mesh(accel)
    r = Renderer(scene, RenderConfig(spp=0), device=dev)
    samples = make_samples(r.scene, r.cfg,
                           torch.Generator(device=dev).manual_seed(6))
    bins, (o, d, dist, valid) = _first_shadow(r, samples)
    assert bins.lights is not None and bins.lights.k == CBN.LIGHT_K
    lid = CBN.shadow_light_ids(o.shape[0], 3, dev)
    tabs = r.tabs.tabs if accel == ACCEL_GRID else r.tabs
    mode = "grid" if accel == ACCEL_GRID else "bvh"
    _accel_reset()
    occ = CBN.binned_shadow_kernel(tabs, bins.lights, lid, o, d, dist, valid,
                                   mode)
    torch.cuda.synchronize()
    assert _accel_launches()["K10"] == 1
    stats = {}
    types = tuple(sorted(set(scene.static.obj_types)))
    ref = CBN.binned_shadow_plain(tabs, bins.lights, lid, o, d, dist, valid,
                                  mode, types, stats)
    assert 0.05 < float(ref[valid].float().mean()) < 0.95
    assert stats["entries"] > 0
    assert torch.equal(occ, ref)
    walk = threaded_walk(tabs, o, d, None, valid, shadow_dist=dist,
                         shadow_mode=mode, types_present=types)
    assert float((walk != occ)[valid].float().mean()) <= 0.002


@pytest.mark.parametrize("accel", [ACCEL_BVH, ACCEL_GRID], ids=["bvh", "grid"])
def test_binned_plus_routes_launch_k10_once(dev, accel, monkeypatch):
    """With SHADOW_BINNING set, the binned+ route launches K9 once, K10 once
    (the primary shadow query) and K7 on the rest, and renders what its
    plain versions render; with the switch off, the same scene takes the
    binned-primary+ route and K10 is never launched."""
    monkeypatch.setattr(CBN, "SHADOW_BINNING", True)
    scene = _box_mesh(accel)
    cfg = RenderConfig(spp=0)
    r = Renderer(scene, cfg, device=dev)
    assert r.executed_backend() == "binned+" + BINNED_PLUS[accel]
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(7))
    _accel_reset()
    img, nrays = r.render_with_samples(samples, return_rays=True)
    torch.cuda.synchronize()
    got = _accel_launches()
    assert {k for k, v in got.items() if v} == {"K7", "K9", "K10"}, got
    assert got["K9"] == 1 and got["K10"] == 1
    assert torch.isfinite(img).all() and float(img.std()) > 0.05
    plain = Renderer(scene, cfg.replace(kernels="off"), device=dev)
    _accel_reset()
    ref, ref_rays = plain.render_with_samples(samples, return_rays=True)
    assert not any(_accel_launches().values())
    assert_images_close(img, ref)
    assert abs(int(nrays) - int(ref_rays)) <= COUNT_BUDGET * int(nrays)
    monkeypatch.setattr(CBN, "SHADOW_BINNING", False)
    off = Renderer(scene, cfg, device=dev)
    assert off.executed_backend() == "binned-primary+" + BINNED_PLUS[accel]
    _accel_reset()
    img_off = off.render_with_samples(samples)
    torch.cuda.synchronize()
    got = _accel_launches()
    assert got["K10"] == 0 and got["K9"] == 1 and got["K7"] > 0
    assert_images_close(img_off, img)


# K10 on every lane: the box-ground scene's bins, lanes of several shapes
K10_CASES = ("ragged", "dead-chains", "scattered", "first-entry")


@pytest.fixture(scope="module")
def k10_frame():
    """The box-ground BVH renderer with LIGHT_K bins and the inputs of its
    primary shadow query."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    dev = torch.device("cuda")
    CBN.SHADOW_BINNING = True
    try:
        r = Renderer(_box_mesh(ACCEL_BVH), RenderConfig(spp=0), device=dev)
    finally:
        CBN.SHADOW_BINNING = False
    samples = make_samples(r.scene, r.cfg,
                           torch.Generator(device=dev).manual_seed(8))
    bins, first = _first_shadow(r, samples)
    return r, bins.lights, first


def _k10_batch(r, lb, first, case):
    """(o, d, dist, valid, light ids) on the card for one case."""
    o, d, dist, valid = first
    n = o.shape[0]
    lid = CBN.shadow_light_ids(n, lb.n_lights, o.device)
    if case == "ragged":  # R not a multiple of 128
        k = n - 51
        return o[:k], d[:k], dist[:k], valid[:k], lid[:k]
    if case == "dead-chains":  # every third chain without a live lane
        v = valid.clone().reshape(-1, CBN.LANES)
        v[::3] = False
        return o, d, dist, v.reshape(-1), lid
    if case == "scattered":
        return _cuda(o.device, *scattered_shadow_batch(
            r.scene.light_pos.cpu().numpy(), 8 * CBN.LANES, seed=2))
    return first_entry_batch(r.tabs, lb, r.scene.light_pos, 96)


@pytest.mark.parametrize("case", K10_CASES)
@pytest.mark.parametrize("mode", ["bvh", "grid"])
def test_binned_shadow_kernel_equals_plain_on_every_lane(k10_frame, mode,
                                                         case):
    """K10 against binned_shadow_plain on every lane, in both shadow
    modes: a ragged lane count; chains with no live lane; origins
    scattered over the scene (a chain's stream spans more than 4 items);
    lanes all occluded by their chain's first entry.  Its work list (the
    first two passes) equals shadow_work_plain's."""
    r, lb, first = k10_frame
    o, d, dist, valid, lid = _k10_batch(r, lb, first, case)
    R = o.shape[0]
    C = -(-R // CBN.LANES)
    occ = CBN.binned_shadow_kernel(r.tabs, lb, lid, o, d, dist, valid, mode)
    occ2 = torch.empty_like(occ)
    args = CBN.shadow_inputs(o, d, dist, valid, lid)
    work = CBN.launch_binned_shadow(r.tabs, lb, args[4], *args[:4], mode,
                                    occ2)
    torch.cuda.synchronize()
    stats = {}
    ref = CBN.binned_shadow_plain(r.tabs, lb, lid, o, d, dist, valid, mode,
                                  stats=stats)
    assert torch.equal(occ, ref) and torch.equal(occ2, ref)
    plain = CBN.shadow_work_plain(lb, lid, o, valid)
    assert torch.equal(work.chains, plain.chains)
    assert torch.equal(work.item_start, plain.item_start)
    nrow = (plain.chains[:, 4] - plain.chains[:, 3] + 1).clamp(min=0)
    upto = torch.arange(lb.k + 1, device=o.device)[None, :] <= nrow[:, None]
    assert torch.equal(torch.where(upto, work.rows, 0), plain.rows)
    it, _ = CBN.shadow_item_entries(lb, plain)
    assert int(torch.bincount(it).max()) <= CBN.ITEM_ENTRIES
    if case == "scattered":
        chain = torch.repeat_interleave(
            torch.arange(C, device=o.device), plain.chains[:, 7].long())
        assert int(torch.bincount(chain[it]).max()) > 4 * CBN.ITEM_ENTRIES
        assert 0.05 < float(ref[valid].float().mean()) < 0.95
    if case == "first-entry":
        assert bool(ref.all()) and int(stats["chain_entries"].max()) == 1
    if case == "dead-chains":
        assert not bool(occ.reshape(-1, CBN.LANES)[::3].any())


# K9 on every lane: the mesh's primary bins, lanes of several shapes
K9_CASES = ("primary", "ragged", "dead-chains", "sparse", "long-chain")


@pytest.fixture(scope="module")
def k9_frame():
    """The BVH and grid renderers of the card tests' mesh, their primary
    bins and the block-permuted primary rays of one SampleSet."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    dev = torch.device("cuda")
    out = {}
    for name, accel in (("bvh", ACCEL_BVH), ("grid", ACCEL_GRID)):
        r = Renderer(_mesh(accel), RenderConfig(spp=0), device=dev)
        H, W = r.scene.static.res_y, r.scene.static.res_x
        bins = r._bins_for(H, W, 1)
        samples = make_samples(r.scene, r.cfg,
                               torch.Generator(device=dev).manual_seed(9))
        o, d, t, _ = _rays_from_samples(r.scene, r.cfg, samples)
        perm = torch.as_tensor(_block_perm(H, W, 1), device=dev).long()
        tabs = r.tabs if accel == ACCEL_BVH else r.tabs.tabs
        out[name] = (tabs, bins.primary, o[perm], d[perm], t[perm])
    return out


def _k9_batch(pb, o, d, t, case):
    """(o, d, time, valid or None) of one case."""
    n = o.shape[0]
    if case == "ragged":  # the last chain 51 lanes short
        v = torch.ones(n - 51, dtype=torch.bool, device=o.device)
        v[::7] = False
        return o[:n - 51], d[:n - 51], t[:n - 51], v
    if case == "dead-chains":  # every third chain without a valid lane
        v = torch.ones((n // CBN.LANES, CBN.LANES), dtype=torch.bool,
                       device=o.device)
        v[::3] = False
        return o, d, t, v.reshape(-1)
    if case == "sparse":
        g = torch.Generator(device=o.device).manual_seed(91)
        return o, d, t, torch.rand(n, generator=g, device=o.device) < 0.05
    if case == "long-chain":  # the longest list's lanes look straight up,
        cs = pb.chain_start.long()  # away from every object: no hit
        c = int(torch.argmax(cs[1:] - cs[:-1]))
        d = d.clone()
        d[c * CBN.LANES:(c + 1) * CBN.LANES] = torch.tensor(
            [0.0, 1.0, 0.0], device=d.device)
        return o, d, t, None
    return o, d, t, None


@pytest.mark.parametrize("case", K9_CASES)
@pytest.mark.parametrize("mode", ["bvh", "grid"])
def test_binned_closest_kernel_equals_plain_on_every_lane(k9_frame, mode,
                                                          case):
    """K9 against binned_closest_plain on every lane of both routes'
    tables: object ids equal, t within 1e-5 relative, normals within
    1e-5; a lane that is not valid reports a miss.  Its work list (the
    first pass) equals closest_work_plain's.  The cases: the frame's
    primary rays, a ragged last chain, chains with no valid lane, 5% of
    the lanes valid, and the longest list's chain looking away from the
    scene, so that it streams every segment of its list."""
    tabs, pb, o, d, t = k9_frame[mode]
    o, d, t, valid = _k9_batch(pb, o, d, t, case)
    _accel_reset()
    kt, kn, kid = CBN.binned_closest_kernel(tabs, pb, o, d, t, valid)
    args = CBN.binned_closest_inputs(o, d, t, valid)
    out = (torch.empty_like(kt), torch.empty_like(kn), torch.empty_like(kid))
    work = CBN.launch_binned_closest(tabs, pb, *args, False, *out)
    torch.cuda.synchronize()
    assert _accel_launches()["K9"] == 1
    stats = {}
    pt, pn, pid = CBN.binned_closest_plain(tabs, pb, o, d, t, valid,
                                           stats=stats)
    v = torch.ones_like(pid, dtype=torch.bool) if valid is None else valid
    for gt, gn, gid in ((kt, kn, kid), out):
        assert torch.equal(gid[v], pid[v])
        assert bool((gid[~v] == -1).all())
        hit = v & (pid >= 0)
        torch.testing.assert_close(gt[hit], pt[hit], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gn[hit], pn[hit], rtol=1e-5, atol=1e-5)
    assert torch.equal(work.item_start, CBN.closest_work_plain(pb).item_start)
    share = float((pid >= 0)[v].float().mean())
    if case == "long-chain":
        cs = pb.chain_start.long()
        c = int(torch.argmax(cs[1:] - cs[:-1]))
        assert not bool((pid[c * CBN.LANES:(c + 1) * CBN.LANES] >= 0).any())
        listed = int(cs[c + 1] - cs[c])
        assert int(stats["chain_groups"][c]) == listed
        assert listed > 2 * CBN.SEGMENT_GROUPS
    else:
        assert 0.2 < share
    if case == "dead-chains":
        assert not bool((kid.reshape(-1, CBN.LANES)[::3] >= 0).any())


# ------------------------------------------------ gradients on the card
from distributionraytracer_tpu_torch.integrator.whitted import (  # noqa: E402
    differentiable_intersectors,
)
from distributionraytracer_tpu_torch.parallel.mesh import (  # noqa: E402
    accel_intersectors, detached, l2_render_loss,
)
from distributionraytracer_tpu_torch.renderer import (  # noqa: E402
    _brute_bvh_intersectors,
)

from torch_scenes import shadow_edge_scene, silhouette_scene  # noqa: E402

GRAD_RTOL = 1e-3  # each gradient element within this x the largest |one|
GRAD_CASES = {
    # scene, leaves whose gradients are compared
    "random": (lambda: create_random_scene(0, 64, 48),
               ("mat_cd", "sph_center", "cam_eye", "light_pos")),
    "prim": (lambda: prim_scene(SceneBuilder),
             ("mat_cd", "sph_center", "tri_v0", "box_min", "light_pos")),
}


def _grad_inputs(dev, kind):
    """A scene on the card, its config, a SampleSet and a target (the K3
    render of the scene with every colour 0.1 darker)."""
    make, leaves = GRAD_CASES[kind]
    scene = make().to(dev)
    cfg = default_config(scene, spp=4)
    samples = make_samples(scene, cfg,
                           torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        dark = dataclasses.replace(
            scene, mat_cd=torch.clamp(scene.mat_cd - 0.1, 0.0, 1.0))
        target = render_from_samples(dark, cfg, samples)
    return scene, cfg, samples, target, leaves


def _loss_and_grads(scene, cfg, samples, target, leaves, inter_of):
    xs = [getattr(scene, n).clone().requires_grad_(True) for n in leaves]
    sc = dataclasses.replace(scene, **dict(zip(leaves, xs)))
    _accel_reset()
    loss = l2_render_loss(sc, cfg, samples, target, inter=inter_of(sc))
    grads = torch.autograd.grad(loss, xs)
    torch.cuda.synchronize()
    return float(loss.detach()), grads, _accel_launches()


def _grads_close(got, ref):
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        scale = float(r.abs().max())
        assert scale > 0
        torch.testing.assert_close(g, r, rtol=0, atol=GRAD_RTOL * scale)


@pytest.mark.parametrize("kind", sorted(GRAD_CASES))
def test_differentiable_brute_route_matches_plain_on_card(dev, kind):
    """K1/K2 under no_grad pick the winners, the hits are recomputed in
    torch: the loss and gradients of the plain route (``kernels='off'``,
    plain autodiff on CUDA tensors)."""
    scene, cfg, samples, target, leaves = _grad_inputs(dev, kind)
    loss, grads, runs = _loss_and_grads(
        scene, cfg, samples, target, leaves,
        lambda sc: accel_intersectors(sc, cfg, None, differentiable=True))
    assert runs["K1"] > 0 and runs["K2"] > 0
    assert sum(runs.values()) == runs["K1"] + runs["K2"], runs
    off = cfg.replace(kernels="off")
    ref_loss, ref_grads, ref_runs = _loss_and_grads(
        scene, off, samples, target, leaves, lambda sc: None)
    assert sum(ref_runs.values()) == 0, ref_runs
    assert ref_loss > 0 and abs(loss - ref_loss) <= 1e-4 * ref_loss
    _grads_close(grads, ref_grads)


def _requiring_grad(scene, leaf):
    return dataclasses.replace(scene, **{
        leaf: getattr(scene, leaf).clone().requires_grad_(True)})


def test_kernel_routes_refuse_a_gradient(dev):
    """A geometry, camera or light leaf that requires a gradient makes
    every kernel route raise (the kernels' outputs carry no graph, so the
    gradient would be silently wrong); under no_grad the same render runs
    and launches as before.  A material leaf trips K3 (its tables hold the
    materials); the staged routes shade in torch, where its gradient is
    exact."""
    scene, cfg, samples, target, _ = _grad_inputs(dev, "random")
    routes = {"K3": lambda s: render_from_samples(s, cfg, samples),
              "K1/K2": lambda s: render_from_samples(
                  s, cfg, samples, inter=brute_intersectors(s, cfg))}
    _accel_reset()
    ref = {k: run(scene) for k, run in routes.items()}
    ref_runs = _accel_launches()
    for leaf in ("sph_center", "cam_eye", "light_pos"):
        for k, run in routes.items():
            with pytest.raises(RuntimeError, match="forward-only"):
                run(_requiring_grad(scene, leaf))
    with pytest.raises(RuntimeError, match="forward-only"):
        routes["K3"](_requiring_grad(scene, "mat_cd"))
    sc = _requiring_grad(scene, "sph_center")
    _accel_reset()
    with torch.no_grad():
        for k, run in routes.items():
            assert torch.equal(run(sc), ref[k]), k
    assert _accel_launches() == ref_runs
    mesh = _mesh(ACCEL_BVH, n_tri=2000, res=(32, 32))
    for kernel in ("grouped", "legacy"):
        r = Renderer(mesh, RenderConfig(spp=0, packet_kernel=kernel),
                     device=dev)
        ms = make_samples(r.scene, r.cfg,
                          torch.Generator(device=dev).manual_seed(0))
        ref = r.render_with_samples(ms)
        plain = r.scene
        r.scene = _requiring_grad(plain, "sph_center")
        with pytest.raises(RuntimeError, match="forward-only"):
            r.render_with_samples(ms)
        with torch.no_grad():
            assert torch.equal(r.render_with_samples(ms), ref)


def test_packet_route_gradients_match_brute_route(dev):
    """The K7 variant of the differentiable intersectors against the brute
    one with the BVH's shadow compare (cost-brute: K1 and K2) on a small
    mesh scene: equal loss and gradients."""
    mesh = _mesh(ACCEL_BVH, n_tri=SMALL_TRI, res=(64, 64))
    r = Renderer(mesh, RenderConfig(spp=1), device=dev)
    assert r.tabs.kind == "grouped"
    cfg = r.cfg
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(2))
    with torch.no_grad():
        target = render_from_samples(r.scene, cfg, samples) * 0.9
    leaves = ("mat_cd", "sph_center", "tri_v0")
    loss, grads, runs = _loss_and_grads(
        r.scene, cfg, samples, target, leaves,
        lambda sc: accel_intersectors(sc, cfg, r.tabs, differentiable=True))
    assert runs["K7"] > 0 and sum(runs.values()) == runs["K7"], runs
    ref_loss, ref_grads, ref_runs = _loss_and_grads(
        r.scene, cfg, samples, target, leaves,
        lambda sc: differentiable_intersectors(
            sc, cfg, _brute_bvh_intersectors(detached(sc), cfg)))
    assert ref_runs["K1"] > 0 and ref_runs["K2"] > 0
    assert ref_loss > 0 and abs(loss - ref_loss) <= 1e-4 * ref_loss
    _grads_close(grads, ref_grads)


def _fd_pairs(f, x0, g, picks, eps=1e-3):
    flat = x0.detach().cpu().numpy().astype(np.float64).ravel()
    out = []
    for i in np.argsort(-np.abs(g.ravel()))[:picks]:
        e = np.zeros_like(flat)
        e[i] = eps
        val = lambda v: float(f(torch.from_numpy(
            v.reshape(x0.shape).astype(np.float32)).to(x0.device)))
        out.append(((val(flat + e) - val(flat - e)) / (2 * eps),
                    g.ravel()[i]))
    return out


FD_CASES = {
    # scene, config, leaf, loss over the image
    "soft-shadow-sphere": (lambda: shadow_edge_scene(SceneBuilder, "sphere"),
                           dict(soft_shadow=0.05), "sph_center",
                           lambda img: img[:, :19].mean()),
    "soft-shadow-triangle": (lambda: shadow_edge_scene(SceneBuilder,
                                                       "triangle"),
                             dict(soft_shadow=0.05), "tri_v0",
                             lambda img: img[:, :19].mean()),
    "soft-silhouette-sphere": (lambda: silhouette_scene(SceneBuilder),
                               dict(soft_silhouette=0.03), "sph_center",
                               torch.mean),
}


@pytest.mark.parametrize("case", sorted(FD_CASES))
def test_soft_estimators_match_finite_differences_on_card(dev, case):
    """test_grad's shadow-edge and sphere-edge constructions on CUDA
    tensors, through the differentiable K1/K2 route (soft shadows; the
    soft silhouettes trace plain torch, as the JAX package's do): autodiff
    within 5% of central differences, and a real edge gradient."""
    make, kw, leaf, reduce = FD_CASES[case]
    scene = make().to(dev)
    cfg = RenderConfig(spp=1, **kw)
    samples = make_samples(scene, cfg,
                           torch.Generator(device=dev).manual_seed(0))

    def f(x):
        sc = dataclasses.replace(scene, **{leaf: x})
        inter = (accel_intersectors(sc, cfg, None, differentiable=True)
                 if cfg.soft_shadow else None)
        return reduce(render_from_samples(sc, cfg, samples, inter=inter))

    x = getattr(scene, leaf).clone().requires_grad_(True)
    _accel_reset()
    (g,) = torch.autograd.grad(f(x), x)
    runs = _accel_launches()
    assert runs["K3"] == 0
    assert (runs["K1"] > 0) == bool(cfg.soft_shadow), runs
    g = g.cpu().numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 1e-3, g
    with torch.no_grad():
        for fd, ad in _fd_pairs(f, getattr(scene, leaf), g, 2):
            assert abs(fd - ad) <= 0.05 * max(abs(fd), abs(ad)) + 1e-4, (
                fd, ad)


# ------------------------------------- grid gradient route, row sharding
def test_grid_route_gradients_match_plain_on_card(dev):
    """``accel_intersectors(CudaGrid, differentiable=True)``: K7 in grid
    shadow mode under no_grad picks the winners; the loss and gradients of
    its plain walk (``kernels='off'``, the same wrapper) and of the DDA
    (``GridArrays``, plain torch on the card)."""
    r = Renderer(_mesh(ACCEL_GRID, n_tri=2000, res=(64, 64)),
                 RenderConfig(spp=1), device=dev)
    cfg = r.cfg
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(4))
    with torch.no_grad():
        target = render_from_samples(r.scene, cfg, samples) * 0.9
    leaves = ("mat_cd", "sph_center", "tri_v0")
    loss, grads, runs = _loss_and_grads(
        r.scene, cfg, samples, target, leaves,
        lambda sc: accel_intersectors(sc, cfg, r.tabs, differentiable=True))
    assert runs["K7"] > 0 and sum(runs.values()) == runs["K7"], runs
    for tables, route_cfg in ((r.tabs, cfg.replace(kernels="off")),
                              (r.accel_build.host, cfg)):
        ref_loss, ref_grads, ref_runs = _loss_and_grads(
            r.scene, route_cfg, samples, target, leaves,
            lambda sc: accel_intersectors(sc, route_cfg, tables,
                                          differentiable=True))
        assert sum(ref_runs.values()) == 0, ref_runs
        assert ref_loss > 0 and abs(loss - ref_loss) <= 1e-4 * ref_loss
        _grads_close(grads, ref_grads)


def test_sharded_render_world_size_one_nccl(dev, tmp_path):
    """``render_image_sharded`` on a world-size-1 NCCL group equals the
    Renderer on accel NONE (K3, the same tiles: equal) and the
    single-process render on a grid scene's CudaGrid tables (K7)."""
    import torch.distributed as dist

    from distributionraytracer_tpu_torch.parallel.mesh import (
        init_file_group, make_row_mesh, render_image_sharded,
    )

    init_file_group(dev, str(tmp_path / "store"))
    try:
        mesh = make_row_mesh(dev)
        assert mesh.world == 1 and dist.get_backend() == "nccl"
        scene = create_random_scene(0, 64, 48)
        cfg = default_config(scene, spp=4)
        r = Renderer(scene, cfg, device=dev)
        samples = make_samples(r.scene, cfg,
                               torch.Generator(device=dev).manual_seed(1))
        assert torch.equal(render_image_sharded(r.scene, cfg, mesh,
                                                samples=samples),
                           r.render_with_samples(samples))
        g = Renderer(_mesh(ACCEL_GRID, n_tri=2000, res=(64, 48)),
                     RenderConfig(spp=0), device=dev)
        gs = make_samples(g.scene, g.cfg,
                          torch.Generator(device=dev).manual_seed(2))
        _accel_reset()
        img = render_image_sharded(g.scene, g.cfg, mesh, samples=gs,
                                   accel=g.tabs)
        assert _accel_launches()["K7"] > 0
        ref = render_from_samples(g.scene, g.cfg, gs, inter=accel_intersectors(
            g.scene, g.cfg, g.tabs))
        assert torch.equal(img, ref)
    finally:
        dist.destroy_process_group()


def test_viewer_progressive_frames_launch_k3(dev):
    """A 32x24 Whitted ViewerState on the card: two progressive frames at
    one camera, each launching K3 (and no K1/K2), and at most 0.5% of the
    elements beyond 3e-3 of the same frames on plain torch (one sample a
    pixel: a lane that flips at an edge keeps its whole difference, so no
    maximum is held)."""
    from distributionraytracer_tpu_torch import viewer as V

    scene = create_random_scene(0, 32, 24)
    cfg = default_config(scene)
    st = V.ViewerState(scene, cfg, device="cuda")
    plain = V.ViewerState(scene, cfg.replace(kernels="off"), device="cuda")
    assert st.renderer.executed_backend() == "fused-level"
    for i in (1, 2):
        CI.reset_launches()
        out = []
        k3 = _k3_kernels(lambda: out.append(
            st.frame(st.alpha0, st.beta0, st.r0, True)))
        rgb, n = out[0]
        assert n == float(i) and rgb.shape == (24, 32, 3)
        assert k3 > 0
        assert CI.LAUNCHES["closest_hit"] == CI.LAUNCHES["any_hit"] == 0
        plain.frame(st.alpha0, st.beta0, st.r0, True)
    diff = (st.prog_state[0] - plain.prog_state[0]).abs()
    assert float((diff > 3e-3).float().mean()) <= 0.005
    assert float(st.prog_state[0].std()) > 0.05


# --------------------------------------------- tile graphs (fused-level)
from distributionraytracer_tpu_torch.utils import spans  # noqa: E402


def _graph_frame(dev, tile_rays=5000):
    """The 64x48 random scene at 16 spp on the card: 49,152 samples, so
    tiles of 5,000 leave a short last tile of 4,152."""
    scene = create_random_scene(0, 64, 48)
    cfg = default_config(scene, spp=16, tile_rays=tile_rays)
    r = Renderer(scene, cfg, device=dev)
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(0))
    return r, samples


def _captures():
    return CW.GRAPHS["captures"]


def test_tile_graphs_frame_is_the_eager_frame_bit_for_bit(dev):
    r, samples = _graph_frame(dev)
    assert r.executed_backend() == "fused-level"
    n_tiles = -(-64 * 48 * 16 // 5000)
    assert _tiles(samples, r.cfg) == n_tiles
    levels = r.cfg.max_depth + 1
    CW.reset_launches()
    with _eager_tiles():
        eager, eager_rays = render_from_samples(r.scene, r.cfg, samples,
                                                return_rays=True)
    eager_k3 = CW.LAUNCHES["fused_level"]
    assert eager_k3 == n_tiles * levels
    for frame in range(3):
        c0, r0 = _captures(), CW.GRAPHS["replays"]
        CW.reset_launches()
        img, nrays = r.render_with_samples(samples, return_rays=True)
        torch.cuda.synchronize()
        # the launcher is called by the two captures and their warm-ups
        assert CW.LAUNCHES["fused_level"] == (4 * levels if frame == 0
                                              else 0)
        assert CW.GRAPHS["replays"] - r0 == n_tiles
        assert _captures() - c0 == (2 if frame == 0 else 0)
        assert torch.equal(img, eager)
        assert int(nrays) == int(eager_rays)
    # the card runs the eager frame's K3 launches, by replays
    assert _k3_kernels(lambda: r.render_with_samples(
        samples, return_rays=True)) == eager_k3
    # without the counts: two more graphs, the same image
    c0 = _captures()
    assert torch.equal(r.render_with_samples(samples), eager)
    assert _captures() - c0 == 2
    assert _k3_kernels(lambda: r.render_with_samples(samples)) == eager_k3


def test_tile_graphs_engage_without_a_renderer(dev):
    """A direct ``render_from_samples`` call on the route makes graphs of
    its own: the same image, the same K3 launches on the card."""
    r, samples = _graph_frame(dev)
    with _eager_tiles():
        eager = render_from_samples(r.scene, r.cfg, samples)
    c0, r0 = _captures(), CW.GRAPHS["replays"]
    img = render_from_samples(r.scene, r.cfg, samples)
    assert torch.equal(img, eager)
    assert _captures() - c0 == 2
    assert CW.GRAPHS["replays"] - r0 == _tiles(samples, r.cfg)


def test_tile_graphs_keep_one_short_tile_graph(dev):
    """A new short last tile replaces the kept one; the full tile's graph
    stays."""
    r, samples = _graph_frame(dev)
    fewer = make_samples(r.scene, r.cfg.replace(spp=9),
                         torch.Generator(device=dev).manual_seed(1))
    assert fewer.time.numel() % 5000 != samples.time.numel() % 5000
    with _eager_tiles():
        refs = [render_from_samples(r.scene, r.cfg, s)
                for s in (samples, fewer)]
    for s, ref, captures in ((samples, refs[0], 2), (fewer, refs[1], 1),
                             (samples, refs[0], 1)):
        c0 = _captures()
        assert torch.equal(r.render_with_samples(s), ref)
        assert _captures() - c0 == captures
        assert len(r._graphs._graphs) == 2


def test_tile_graphs_viewer_frames_are_the_eager_frames(dev):
    from distributionraytracer_tpu_torch import viewer as V

    scene = create_random_scene(0, 64, 48)
    cfg = default_config(scene)
    st = V.ViewerState(scene, cfg, device="cuda")
    eager = V.ViewerState(scene, cfg, device="cuda")
    cams = [(st.alpha0, st.beta0, st.r0), (st.alpha0 + 20.0, st.beta0, st.r0),
            (st.alpha0 - 15.0, st.beta0 + 5.0, st.r0 * 1.1)]
    after_first = None
    for i in range(10):
        cam = cams[min(i // 4, 2)]
        rgb, n = st.frame(*cam, True)
        with _eager_tiles():
            ref, ref_n = eager.frame(*cam, True)
        if after_first is None:
            after_first = _captures()
        assert n == ref_n and np.array_equal(rgb, ref)
        assert torch.equal(st.prog_state[0], eager.prog_state[0])
    assert _captures() == after_first


def test_tile_graphs_recapture_on_new_materials(dev):
    r, samples = _graph_frame(dev)
    before = r.render_with_samples(samples)
    c0 = _captures()
    red = torch.zeros_like(r.scene.mat_cd)
    red[:, 0] = 1.0
    r.scene = dataclasses.replace(r.scene, mat_cd=red)
    img = r.render_with_samples(samples)
    assert _captures() - c0 == 2
    with _eager_tiles():
        assert torch.equal(img, render_from_samples(r.scene, r.cfg, samples))
    assert not torch.equal(img, before)
    c0 = _captures()
    with torch.no_grad():
        r.scene.mat_cd[:, 1] = 1.0  # in place: a new _version
    img = r.render_with_samples(samples)
    assert _captures() - c0 == 2
    with _eager_tiles():
        assert torch.equal(img, render_from_samples(r.scene, r.cfg, samples))


def test_tile_graphs_count_what_the_eager_tiles_count(dev):
    r, samples = _graph_frame(dev)

    def recorded(run):
        spans.collect()
        spans.enable()
        try:
            with spans.span("render.frame"):
                run()
        finally:
            spans.disable()
        rec = spans.collect()
        out = {}
        for c in rec["counts"]:
            out[c["name"]] = out.get(c["name"], 0) + c["n"]
        return out, [s["name"] for s in rec["spans"]]

    with _eager_tiles():
        eager, eager_spans = recorded(
            lambda: render_from_samples(r.scene, r.cfg, samples))
    r.render_with_samples(samples)  # the uncounted graphs, captured
    c0 = _captures()
    got, got_spans = recorded(lambda: r.render_with_samples(samples))
    assert _captures() - c0 == 2  # the counting graphs
    tiles = got_spans.count("render.tile")
    again, _ = recorded(lambda: r.render_with_samples(samples))
    for c in (got, again):
        for k in ("whitted.lanes", "whitted.lanes_live",
                  "whitted.shadow_rays", "whitted.levels_in_place"):
            assert c[k] == eager[k], k
        assert c["whitted.graph_replays"] == tiles
    assert got["whitted.graph_captures"] == 2
    assert "whitted.graph_captures" not in again
    assert got_spans.count("whitted.graph") == tiles
    assert "whitted.level" not in got_spans and "whitted.level" in eager_spans


def test_tile_graphs_bypass_other_routes(dev):
    r, samples = _graph_frame(dev)
    c0 = _captures()
    # rtow.invert's route: the differentiable K1/K2 intersectors
    sc = _requiring_grad(r.scene, "mat_cd")
    inter = accel_intersectors(sc, r.cfg, None, differentiable=True)
    loss = render_from_samples(sc, r.cfg, samples, inter=inter,
                               graphs=r._graphs).mean()
    loss.backward()
    assert sc.mat_cd.grad is not None
    # the fused-level route with a leaf that requires a gradient refuses,
    # as the eager tiles do
    r2, _ = _graph_frame(dev)
    r2.scene = _requiring_grad(r2.scene, "sph_center")
    with pytest.raises(RuntimeError, match="forward-only"):
        r2.render_with_samples(samples)
    # a BVH scene's packet route, kernels='off', a skybox
    mesh = _mesh(ACCEL_BVH, n_tri=2000, res=(32, 32))
    rb = Renderer(mesh, RenderConfig(spp=0), device=dev)
    rb.render_with_samples(make_samples(rb.scene, rb.cfg))
    off = Renderer(create_random_scene(0, 64, 48),
                   r.cfg.replace(kernels="off"), device=dev)
    off.render_with_samples(samples)
    sky = Renderer(with_skybox(create_random_scene(0, 64, 48)), r.cfg,
                   device=dev)
    img = sky.render_with_samples(samples)
    assert torch.equal(img, render_from_samples(sky.scene, sky.cfg, samples))
    torch.cuda.synchronize()
    assert _captures() == c0


# ------------------- K3 writes its children into the next level's streams
def _streams_close(got, want, budget=BUDGET):
    """Two (rows, lanes) outputs of a level: the lanes where a row differs
    (by more than 2e-4 plus 1e-5 of its magnitude) are at most ``budget``
    of the lanes."""
    off = ~torch.isclose(got, want, rtol=1e-5, atol=2e-4).all(0)
    assert float(off.float().mean()) <= budget, float(off.float().mean())


def _first_streams(o, d, t, ls):
    ones = torch.ones_like(t)
    return CI.ray_streams(t.shape[0], o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                          d[:, 1], d[:, 2], t, ones, ls[:, 0], ls[:, 1], ones)


@pytest.mark.parametrize("grid", [False, True], ids=["none", "grid"])
@pytest.mark.parametrize("name", ["random", "refl", "refr"])
def test_level_into_kernel_matches_plain(dev, name, grid):
    """K3's ``next`` streams and combine rows against the plain version's
    at every level of a frame's tree, each level fed the plain version's
    streams: the valid rows equal on every lane (written, though ``next``
    starts as NaN), the rest within the budgets on valid lanes."""
    scene = (create_random_scene(0, 64, 48) if name == "random"
             else one_kind_scene(SceneBuilder, name)).to(dev)
    cfg = default_config(scene, spp=4)
    kinds, levels = _tree_shape(scene, cfg)
    box = ((np.array([-12, -2, -12], np.float32),
            np.array([12, 3, 12], np.float32)) if grid else None)
    samples = make_samples(scene, cfg,
                           torch.Generator(device=dev).manual_seed(5))
    o, d, t, ls = RD._rays_from_samples(scene, cfg, samples)
    R, tb = o.shape[0], CW.level_tables(scene)
    rays = _first_streams(o, d, t, ls)
    for level in range(levels):
        spawn = level < levels - 1
        shape = (11, len(kinds) * rays.shape[1])
        got = torch.full(shape, float("nan"), device=dev) if spawn else None
        want = torch.empty(shape, device=dev) if spawn else None
        out = CW.level_into_kernel(scene, cfg, rays, got, R, kinds, tb, box)
        ref = CW.level_into_plain(scene, cfg, rays, want, R, kinds, tb, box)
        v = rays[10] != 0.0
        _streams_close(out[:, v], ref[:, v])
        if not spawn:
            break
        assert not bool(got[10].isnan().any())
        assert _mismatch(got[10], want[10]) <= BUDGET
        both = (got[10] != 0.0) & (want[10] != 0.0)
        assert int(both.sum()) > 0
        _streams_close(got[:, both], want[:, both])
        rays = want


def _rtow_tile(dev, tile_rays=65536):
    """``rtow_final``'s scene at 800x600 and 16 spp, and the rays of the
    frame's middle tile (the first tiles are the floor's)."""
    scene = create_random_scene(0, 800, 600).to(dev)
    cfg = default_config(scene, spp=16, tile_rays=tile_rays)
    samples = make_samples(scene, cfg,
                           torch.Generator(device=dev).manual_seed(1))
    rays = RD._rays_from_samples(scene, cfg, samples)
    a = (rays[0].shape[0] // tile_rays // 2) * tile_rays
    return scene, cfg, tuple(x[a:a + tile_rays].contiguous() for x in rays)


def test_graphed_and_eager_tiles_equal_the_old_expansion(dev):
    """A full ``rtow_final`` tile, graphed and eager, gives the colours of
    the same tile traced with the old expansion (``torch_level_chain``),
    bit for bit."""
    scene, cfg, rays = _rtow_tile(dev)
    tb = CW.level_tables(scene)
    want = old_trace_k3(scene, cfg, *rays, tb)
    eager, _ = trace_whitted(scene, cfg, *rays, tables=tb)
    g = RD.TileGraphs()
    g.prepare(scene, cfg)
    graphed = torch.empty_like(want)
    g.trace(scene, cfg, rays, graphed, False, True)
    g.trace(scene, cfg, rays, graphed, False, True)  # a replay
    torch.cuda.synchronize()
    assert float(want.std()) > 0.01
    assert torch.equal(eager, want)
    assert torch.equal(graphed, want)


@pytest.mark.parametrize("case", ["grid", "skybox", "refl", "refr"])
def test_eager_k3_tiles_equal_the_old_expansion(dev, case):
    """K3's grid mode (``fused_grid``), a skybox scene (whose lookup reads
    every lane's direction) and one-kind trees, eager, against the old
    expansion, bit for bit."""
    scene = (one_kind_scene(SceneBuilder, case) if case in ("refl", "refr")
             else create_random_scene(0, 96, 64))
    if case == "skybox":
        scene = with_skybox(scene)
    scene = scene.to(dev)
    box = ((np.array([-12, -2, -12], np.float32),
            np.array([12, 3, 12], np.float32)) if case == "grid" else None)
    cfg = default_config(scene, spp=4)
    samples = make_samples(scene, cfg,
                           torch.Generator(device=dev).manual_seed(2))
    rays = RD._rays_from_samples(scene, cfg, samples)
    tb = CW.level_tables(scene)
    want = old_trace_k3(scene, cfg, *rays, tb, box)
    got, _ = trace_whitted(scene, cfg, *rays, tables=tb, fused_grid=box)
    torch.cuda.synchronize()
    assert float(want.std()) > 0.01
    assert torch.equal(got, want)


def test_pt_frame_matches_the_benchmark_reference_on_card(dev):
    """A 64x48, 16-spp, 10-bounce frame of scene 0 through ``render_pt``
    (K6) with injected samples, against the benchmark's plain reference
    path tracer over the same samples, judged by the ``pt0.frame`` cell's
    own comparison and limits."""
    from portbench import harness
    from portbench.reference import pt_scene
    from portbench.traffic import pt_frames

    cfg = dict(harness.load_json("configs", "pt_scene0.json"), res_x=64,
               res_y=48)
    limits = harness.load_json("workloads", "pt0.frame.json")["params"][
        "limits"]
    drawn = pt_frames.draw(cfg, 2**40 + 17, 0, dev)
    jitter, times, uni = drawn
    CP.reset_launches()
    got = PT.render_pt(PS.scene0().to(dev),
                       RenderConfig(max_bounces=cfg["max_bounces"]), 64, 48,
                       eye=cfg["eye"], at=cfg["at"], fovy=cfg["fovy"],
                       spp=cfg["spp"],
                       samples=PT.PTSamples(jitter, times,
                                            PT.BounceUniforms(*uni)))
    assert CP.LAUNCHES["pt_trace"] == 1 and CP.LAUNCHES["pt_bounce"] == 0
    want = pt_frames.reference_pixels(pt_scene.ref_scene(cfg, dev), cfg,
                                      drawn, None)
    checks = pt_frames.compare([(got, want)], limits)
    assert checks.correct, checks.lines()
