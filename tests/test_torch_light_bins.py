"""The light-frustum shadow route against the JAX package: the light bins,
K10's plain version (``binned_shadow_plain``) and the ``binned+`` frames.

The JAX package sends a primary shadow query to ``binned_shadow`` only
where its renderer holds light bins, and its ``SHADOW_BINNING`` switch is
off, so these tests set the bins themselves, as ``test_binned`` does.  The
scene is ``mesh_scene(..., ground="box")``: its finite ground keeps the
point lights outside the scene box, where the bins build.

Interpret-mode cost: the JAX kernels' interpret mode traces and lowers
their unrolled bodies on the CPU (about a minute for K9, half a minute for
K10 with one chain a grid step, whatever the frame's size).  So the JAX
frames here take the JAX
package's own render functions (``_render_bvh``, ``_render_grid``) on its
binned route with light bins only: K10 in interpret mode on the primary
shadow query, the package's XLA walks (threaded BVH, grid DDA) in place of
its interpret-mode packet kernels everywhere else, the primary closest hit
included (plain K9 is held to the JAX K9 in ``test_torch_binned``).  K10
runs with ``pallas_binned.CHAINS`` set to 1, which only batches chains into
one (8, 128) TPU tile (no lane's result depends on it), so its body is
compiled once instead of eight times.  The frames use bins of ``SMALL_K``
tiles per axis: at 16x16 pixels a chain's origins cover a large share of a
light's view, and at 128 tiles per axis its rectangle repeats the ground's
group in thousands of tiles.  The bins are built by the same operations at
every K; ``test_light_bins_match_jax`` holds them at ``LIGHT_K``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributionraytracer_tpu import renderer as jren
from distributionraytracer_tpu.accel import pallas_binned as jbin
from distributionraytracer_tpu.accel.bvh import make_threaded_intersectors
from distributionraytracer_tpu.accel.grid import make_grid_intersectors
from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.renderer import Renderer as JaxRenderer
from distributionraytracer_tpu.scene.builder import (
    SceneBuilder as JaxSceneBuilder,
)
from distributionraytracer_tpu_torch.accel import cuda_binned as tbin
from distributionraytracer_tpu_torch.accel import cuda_packet as tpp
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.whitted import Intersectors
from distributionraytracer_tpu_torch.ops.common import FLT_MAX
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene.types import ACCEL_BVH, ACCEL_GRID

from test_torch_render import shared_samples
from test_whitted import assert_images_close
from torch_port_util import to_port, torch_samples
from torch_scenes import mesh_scene

torch.set_num_threads(1)

SMALL_K = 16  # tiles per axis of the light bins the frames use
RES = (16, 16)
LABELS = {ACCEL_BVH: "binned+grouped-packet", ACCEL_GRID: "binned+grid-packet"}
MODES = {ACCEL_BVH: "bvh", ACCEL_GRID: "grid"}


def _mesh(accel, ground="box", res=RES, n_tri=2000):
    return mesh_scene(JaxSceneBuilder, n_tri=n_tri, accel=accel, res=res,
                      ground=ground)


def _jax_renderer(js):
    return JaxRenderer(js, JaxConfig(spp=0, accel_backend="pallas",
                                     accel_cost_threshold=0))


def _port_renderer(js, K=SMALL_K):
    """The port's Renderer (CPU, plain versions) with light bins of K tiles
    per axis, set as the renderer sets them under SHADOW_BINNING."""
    r = Renderer(to_port(js), RenderConfig(spp=0, accel_cost_threshold=0),
                 device="cpu")
    lb = tbin.build_light_bins(r.scene, r._gbox, K)
    assert tbin.shadow_binning_ok(r.scene, lb)
    r._light_bins = lb
    return r


def _port_tables(gj):
    return tpp.from_jax_grouped(gj.node_g, gj.obj_g, gj.og_base, gj.n_nodes,
                                gj.n_groups)


# --------------------------------------------------------------- the bins
@pytest.mark.parametrize("accel", [ACCEL_BVH, ACCEL_GRID], ids=["bvh", "grid"])
def test_light_bins_match_jax(accel):
    """``build_light_bins`` at LIGHT_K on the JAX package's own tables:
    ``tile_start`` and ``frames`` array-equal, each entry's group the JAX
    slab's column, its distance the slab's distance rows; the JAX bins
    carried across by ``from_jax_light_bins`` equal the port's."""
    js = _mesh(accel)
    jr = _jax_renderer(js)
    gj = jr._bins_tabs
    ref = jax.device_get(jbin.build_light_bins(js, jr._gbox, gj))
    assert ref is not None
    tabs = _port_tables(gj)
    ps = to_port(js)
    gbox = tbin.group_boxes(ps, tabs)
    G = gbox.shape[0]  # the JAX columns past G are lane padding
    assert np.array_equal(gbox, jr._gbox[:G]) and not jr._gbox[G:, 6].any()
    got = tbin.build_light_bins(ps, gbox)
    assert got.k == tbin.LIGHT_K and got.n_lights == 3
    ts = np.asarray(ref.tile_start)
    assert np.array_equal(got.tile_start.numpy(), ts)
    assert ts.shape == (3 * tbin.LIGHT_K ** 2 + 1,)
    assert np.array_equal(got.frames.numpy(), np.asarray(ref.frames))
    n = int(ts[-1])
    slab = np.asarray(ref.slab)
    group = got.group.numpy()
    assert np.array_equal(np.asarray(gj.obj_g)[:, group[:n]], slab[:112, :n])
    for row in range(112, 120):
        assert np.array_equal(got.dist.numpy()[:n], slab[row, :n])
    assert got.group.shape[0] % tbin.P_BUCKET == 0
    assert (got.dist.numpy()[n:] == np.float32(FLT_MAX)).all()
    carried = tbin.from_jax_light_bins(tabs, ref.tile_start, ref.frames,
                                       ref.slab)
    for a, b in zip(carried, got):
        assert torch.equal(a, b)


def _lights_at(js, pos):
    return dataclasses.replace(js, light_pos=np.asarray(pos, np.float32))


def _refusal_case(case):
    """(JAX scene, whether its bins build and route)."""
    if case == "ground-sphere":
        return _mesh(ACCEL_BVH, ground="sphere"), False
    js = _mesh(ACCEL_GRID if case.startswith("grid") else ACCEL_BVH)
    gbox = _jax_renderer(js)._gbox
    live = gbox[:, 6] > 0
    lo, hi = gbox[live, 0:3].min(0), gbox[live, 3:6].max(0)
    if case == "light-inside":
        return _lights_at(js, np.broadcast_to((lo + hi) / 2, (3, 3))), False
    if case in ("grid-light-near", "bvh-light-near"):
        # 0.5 above the box: inside a grid scene's 1.05, outside 1e-3
        above = [(lo[0] + hi[0]) / 2, hi[1] + 0.5, (lo[2] + hi[2]) / 2]
        return _lights_at(js, [above] * 3), case == "bvh-light-near"
    assert case == "quad-light"
    st = dataclasses.replace(js.static, light_quad=(True, False, False))
    return dataclasses.replace(js, static=st), False


@pytest.mark.parametrize("case", ["light-inside", "ground-sphere",
                                  "grid-light-near", "bvh-light-near",
                                  "quad-light"])
def test_light_bin_refusals_match_jax(case):
    """Both packages refuse the same scenes: a light inside the scene box, the
    radius-1000 ground sphere (its box reaches behind the lights), a grid
    light nearer the box than 1.05 (a BVH scene takes the same light), a
    quad light (``shadow_binning_ok``)."""
    js, builds = _refusal_case(case)
    jr = _jax_renderer(js)
    ref = jbin.build_light_bins(js, jr._gbox, jr._bins_tabs)
    ps = to_port(js)
    got = tbin.build_light_bins(ps, jr._gbox)
    assert (ref is None) == (got is None)
    ok = tbin.shadow_binning_ok(ps, got)
    assert ok == jbin.shadow_binning_ok(js, ref) == builds
    if case == "quad-light":
        assert got is not None and not ok


# ------------------------------------------------- the JAX binned+ frames
@pytest.fixture(scope="module", params=[ACCEL_BVH, ACCEL_GRID],
                ids=["bvh", "grid"])
def accel(request):
    return request.param


@pytest.fixture(scope="module")
def jax_frame(accel):
    """The JAX package's frame of one SampleSet on its binned route with
    light bins only (``_render_bvh`` / ``_render_grid``, see the module
    docstring): K10 on the primary shadow query, the XLA walk elsewhere.
    Returns the frame, its label with the light bins set, and the K10
    call's inputs and output."""
    js = _mesh(accel)
    calls = []
    kernel = jbin.binned_shadow

    def recorded(scene, tabs, lbins, light_id, o, d, dist, motion_blur=False,
                 interpret=False, valid=None, shadow_mode="bvh",
                 K=jbin.LIGHT_K):
        del K  # the bins' own
        occ = kernel(scene, tabs, lbins, light_id, o, d, dist, motion_blur,
                     interpret=interpret, valid=valid,
                     shadow_mode=shadow_mode, K=SMALL_K)
        jax.debug.callback(
            lambda *a: calls.append(dict(zip(
                ("light_id", "o", "d", "dist", "valid", "occ"),
                (np.asarray(x) for x in a)), mode=shadow_mode)),
            light_id, o, d, dist, valid, occ, ordered=True)
        return occ

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbin, "CHAINS", 1)
        mp.setattr(jbin, "binned_shadow", recorded)
        jr = _jax_renderer(js)
        lb = jbin.build_light_bins(js, jr._gbox, jr._bins_tabs, K=SMALL_K)
        assert jbin.shadow_binning_ok(js, lb)
        jr._light_bins = jax.device_put(lb)
        if accel == ACCEL_GRID:
            inner = make_grid_intersectors(jr.scene, jr.grid, False,
                                           unroll=jr.grid_unroll)
        else:
            inner = make_threaded_intersectors(jr.scene, jr.bvh, False)
        mp.setattr(jren, "packet_intersectors", lambda *a, **k: inner)
        samples = shared_samples(js, 1, seed=8)
        bins = jbin.BinSet(primary=None, lights=jr._light_bins)
        zero = jax.numpy.zeros((), jax.numpy.float32)
        if accel == ACCEL_GRID:
            img = jren._render_grid(jr.scene, jr.cfg, jr.grid, jr.grid_pallas,
                                    samples, zero, jr.grid_unroll, False,
                                    bins)
        else:
            img = jren._render_bvh(jr.scene, jr.cfg, jr.bvh, jr.bvh_tabs,
                                   samples, zero, False, bins)
        img = np.asarray(img)
        jax.effects_barrier()
    assert len(calls) == 1
    calls[0]["lbins"] = jax.device_get(lb)
    return {"js": js, "label": jr.executed_backend(), "samples": samples,
            "img": img, "k10": calls[0], "tabs": jr._bins_tabs}


@pytest.fixture(scope="module")
def port_frame(accel):
    """The port's binned+ frame of the same scene and SampleSet (plain K9,
    K10 and K7 walks on the CPU)."""
    js = _mesh(accel)
    r = _port_renderer(js)
    samples = torch_samples(shared_samples(js, 1, seed=8))
    return {"r": r, "label": r.executed_backend(), "samples": samples,
            "img": r.render_with_samples(samples).numpy()}


def test_plain_k10_matches_jax_kernel(accel, jax_frame):
    """``binned_shadow_plain`` on the JAX frame's own K10 inputs (its primary
    shadow batch, 3 lights x 256 lanes) and on the JAX package's tables
    and bins, against the JAX ``binned_shadow`` (interpret mode) output:
    equal on every lane, in the route's shadow mode."""
    k = jax_frame["k10"]
    assert k["mode"] == MODES[accel]
    tabs = _port_tables(jax_frame["tabs"])
    lb = tbin.from_jax_light_bins(tabs, k["lbins"].tile_start,
                                  k["lbins"].frames, k["lbins"].slab)
    assert lb.k == SMALL_K
    T = torch.from_numpy
    valid = k["valid"].astype(bool)
    stats = {}
    occ = tbin.binned_shadow_plain(tabs, lb, T(k["light_id"]), T(k["o"]),
                                   T(k["d"]), T(k["dist"]), T(valid),
                                   shadow_mode=k["mode"], stats=stats)
    ref = k["occ"]
    assert ref.shape == (3 * RES[0] * RES[1],)
    assert 0.05 < ref[valid].mean() < 0.95
    assert np.array_equal(occ.numpy(), ref)
    assert stats["entries"] > 0 and stats["obj_tests"] > 0


def test_binned_render_matches_jax(accel, jax_frame, port_frame):
    """The port's binned+ frame (plain K9, K10, K7) against the JAX
    package's frame with K10 on the same SampleSet: equal labels, the
    frames within ``assert_images_close``'s budget (the walks sum their dot
    products in other orders)."""
    assert port_frame["label"] == jax_frame["label"] == LABELS[accel]
    ref = jax_frame["img"]
    assert ref.std() > 0.05
    assert_images_close(port_frame["img"], ref)


def test_plain_route_matches_packet_render(accel, port_frame):
    """The port's binned+ frame (plain K9 and K10) against the same
    Renderer's packet-only frame, on one SampleSet (``test_binned``'s
    budget)."""
    r = port_frame["r"]
    r._gbox = None  # the packet route only
    assert not r.executed_backend().startswith("binned")
    img_p = r.render_with_samples(port_frame["samples"]).numpy()
    img_b = port_frame["img"]
    diff = np.abs(img_b - img_p).max(axis=-1)
    assert (diff > 1e-5).sum() <= img_b.shape[0] * img_b.shape[1] * 0.002


# ------------------------------------------------------------- routing
def _shadow_batch(r, n_per_light, seed=0):
    """Shadow rays towards each light in turn from points about the mesh:
    origins, unit directions, distances, a valid mask (every 5th lane
    dead)."""
    rng = np.random.default_rng(seed)
    lp = r.scene.light_pos.numpy().astype(np.float64)
    o = rng.uniform([-2.5, 0.05, -2.5], [2.5, 2.5, 2.5], (n_per_light, 3))
    o = np.concatenate([o] * lp.shape[0])
    d = np.repeat(lp, n_per_light, axis=0) - o
    dist = np.linalg.norm(d, axis=1)
    valid = np.ones(o.shape[0], bool)
    valid[::5] = False
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return T(o), T(d / dist[:, None]), T(dist), torch.from_numpy(valid)


def test_k10_takes_only_the_first_whole_chain_shadow_call():
    """K10 (its plain version here) takes the first shadow call only, and
    only where each light's run fills whole chains; every other call goes
    to the inner walk.  The JAX package's ``lane // rn`` light ids, which
    give every lane light 0 when a run does not fill whole chains, are not
    copied."""
    js = _mesh(ACCEL_BVH, res=(16, 16))
    r = _port_renderer(js)
    bins = r._bins_for(16, 16, 1)
    assert bins.lights is not None
    seen = []

    def inner_shadow(o, d, dist, exclude_obj, valid=None):
        seen.append(o.shape[0])
        return torch.zeros(o.shape[0], dtype=torch.bool)

    inner = Intersectors(None, inner_shadow)

    def fresh():
        return tbin.leveled_binned_intersectors(r.scene, r.tabs, bins, inner)

    o, d, dist, valid = _shadow_batch(r, 256)
    ex = torch.full((o.shape[0],), -1, dtype=torch.int32)
    inter = fresh()
    occ = inter.shadow(o, d, dist, ex, valid=valid)
    assert seen == []
    lid = torch.arange(768, dtype=torch.int32) // 256
    ref = tbin.binned_shadow_plain(r.tabs, bins.lights, lid, o, d, dist,
                                   valid)
    assert torch.equal(occ, ref) and 0.05 < float(occ[valid].float().mean())
    inter.shadow(o, d, dist, ex, valid=valid)
    assert seen == [768]
    for n_per_light in (100, 200):  # runs of 100 and 200 lanes
        seen.clear()
        o2, d2, dist2, v2 = _shadow_batch(r, n_per_light)
        fresh().shadow(o2, d2, dist2, ex[:o2.shape[0]], valid=v2)
        assert seen == [3 * n_per_light]
    assert tbin.shadow_light_ids(769, 3, "cpu") is None
    assert tbin.shadow_light_ids(300, 3, "cpu") is None
    assert torch.equal(tbin.shadow_light_ids(100, 1, "cpu"),
                       torch.zeros(100, dtype=torch.int32))
    assert torch.equal(tbin.shadow_light_ids(768, 3, "cpu"), lid)


def test_renderer_builds_light_bins_under_the_switch(monkeypatch):
    """The Renderer builds light bins (at LIGHT_K) only while
    ``SHADOW_BINNING`` is set and they build; its label follows."""
    box = to_port(_mesh(ACCEL_BVH, res=(16, 16)))
    sphere = to_port(_mesh(ACCEL_BVH, ground="sphere", res=(16, 16)))
    cfg = RenderConfig(spp=0, accel_cost_threshold=0)
    assert tbin.SHADOW_BINNING is False
    r = Renderer(box, cfg, device="cpu")
    assert r._light_bins is None
    assert r.executed_backend() == "binned-primary+grouped-packet"
    monkeypatch.setattr(tbin, "SHADOW_BINNING", True)
    r = Renderer(box, cfg, device="cpu")
    assert r._light_bins.k == tbin.LIGHT_K
    assert r.executed_backend() == "binned+grouped-packet"
    r = Renderer(sphere, cfg, device="cpu")
    assert r._light_bins is None
    assert r.executed_backend() == "binned-primary+grouped-packet"
