"""When the fused-level route replays its tiles as CUDA graphs (the
``graph`` mode of ``integrator.whitted._tile_mode``, ``TileGraphs``), on
the CPU: the tile mode as a pure function, what a frame's inputs hand it
(``integrator.render._plan_frame``), when ``TileGraphs`` keeps and when it
rebuilds its K3 tables, which graphs it keeps, the recorder's pause that
its capture runs under, that every CPU render stays on the eager path, and
that ``trace_whitted`` takes the K3 tables from its caller.  The graphs
themselves run only on the card (``tests/test_torch_cuda.py``).  CPU only;
no JAX."""

import dataclasses
import threading

import pytest
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator import render as RD
from distributionraytracer_tpu_torch.integrator.render import (
    TileGraphs, make_samples, render_from_samples,
)
from distributionraytracer_tpu_torch.integrator.whitted import (
    _tile_mode, brute_intersectors, trace_whitted, tree_nodes,
)
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene.procedural import (
    create_random_scene,
)
from distributionraytracer_tpu_torch.utils import spans

torch.set_num_threads(1)

# _tile_mode's arguments, in order, on the card's fused-level route
ENGAGED = dict(route="fused-level", inter=None, fused_grid=None,
               soft_silhouette=0.0, device_type="cuda", needs_grad=False,
               skybox=False)
# case: (what differs from ENGAGED, the mode its tiles take instead)
BYPASSES = {
    "cpu": (dict(device_type="cpu"), "k3"),
    "brute-kernel": (dict(route="brute-kernel"), "staged"),
    "plain": (dict(route="plain"), "staged"),
    "intersectors": (dict(inter=object()), "staged"),
    "fused-grid": (dict(fused_grid=((0.0,) * 3, (1.0,) * 3)), "k3"),
    "soft-silhouette": (dict(soft_silhouette=0.01), "soft"),
    "gradient": (dict(needs_grad=True), "k3"),
    "skybox": (dict(skybox=True), "k3"),
}


def test_graph_engages_on_the_cards_fused_level_route():
    assert _tile_mode(**ENGAGED) == "graph"


@pytest.mark.parametrize("case", sorted(BYPASSES))
def test_graph_bypasses(case):
    over, mode = BYPASSES[case]
    assert _tile_mode(**{**ENGAGED, **over}) == mode


def small_frame(tile_rays=100, spp=1):
    scene = create_random_scene(0, 24, 16)
    cfg = RenderConfig(spp=spp, tile_rays=tile_rays)
    r = Renderer(scene, cfg, device="cpu")
    samples = make_samples(r.scene, cfg, torch.Generator().manual_seed(3))
    return r, samples


@pytest.fixture
def seen(monkeypatch):
    """The arguments a frame's inputs hand ``_tile_mode``."""
    calls = []

    def record(*args):
        calls.append(dict(zip(ENGAGED, args)))
        return _tile_mode(*args)

    monkeypatch.setattr(RD, "_tile_mode", record)
    return calls


def _rays(r, requires_grad=False, n=8):
    o, d = torch.zeros((n, 3)), torch.ones((n, 3))
    return (o.requires_grad_(requires_grad), d, torch.zeros(n),
            torch.zeros((n, 3)))


def test_engages_reads_device_route_and_config(seen):
    r, samples = small_frame()
    assert RD._plan_frame(r.scene, r.cfg, samples).mode == "k3"
    assert seen[-1] == dict(ENGAGED, device_type="cpu")
    inter = brute_intersectors(r.scene, r.cfg)
    plan = RD._plan_frame(r.scene,
                          r.cfg.replace(kernels="off", soft_silhouette=0.5),
                          samples, inter)
    assert plan.mode == "staged" and plan.inter is inter
    assert seen[-1]["route"] == "plain" and seen[-1]["inter"] is inter
    assert seen[-1]["soft_silhouette"] == 0.5


@pytest.mark.parametrize("leaf", ["rays", "mat_cd", "sph_center",
                                  "light_pos", "bg_color"])
def test_engages_sees_a_gradient_only_where_one_is_recorded(seen, leaf):
    r, samples = small_frame()
    scene, grad_samples = r.scene, samples
    if leaf == "rays":  # the pixel samples the rays are made from
        grad_samples = dataclasses.replace(
            samples, pixel=samples.pixel.clone().requires_grad_())
    else:
        scene = dataclasses.replace(
            scene, **{leaf: getattr(scene, leaf).clone().requires_grad_()})
    RD._plan_frame(scene, r.cfg, grad_samples)
    assert seen[-1]["needs_grad"]
    with torch.no_grad():
        RD._plan_frame(scene, r.cfg, grad_samples)
    assert not seen[-1]["needs_grad"]
    RD._plan_frame(r.scene, r.cfg, samples)
    assert not seen[-1]["needs_grad"]


def test_tables_are_kept_across_camera_moves_and_rebuilt_on_scene_changes():
    r, _ = small_frame()
    g = TileGraphs()
    g.prepare(r.scene, r.cfg)
    first = g.tables
    ref = CW.level_tables(r.scene)
    for a, b in zip(first, ref):
        assert torch.equal(a, b)
    g._graphs["held"] = object()  # stands in for a captured graph

    moved = dataclasses.replace(r.scene, cam_eye=r.scene.cam_eye + 1.0)
    g.prepare(moved, r.cfg)
    assert g.tables is first and "held" in g._graphs

    red = torch.zeros_like(moved.mat_cd)
    red[:, 0] = 1.0
    recoloured = dataclasses.replace(moved, mat_cd=red)
    g.prepare(recoloured, r.cfg)
    assert g.tables is not first and not g._graphs
    assert torch.equal(g.tables.mrow, CW.level_tables(recoloured).mrow)
    assert not torch.equal(g.tables.mrow, first.mrow)

    second = g.tables
    g._graphs["held"] = object()
    with torch.no_grad():
        recoloured.sph_radius.mul_(2.0)  # the same tensor, a new _version
    g.prepare(recoloured, r.cfg)
    assert g.tables is not second and not g._graphs
    assert torch.equal(g.tables.data, CW.level_tables(recoloured).data)

    third = g.tables
    g.prepare(recoloured, r.cfg.replace(max_depth=2))
    assert g.tables is not third


def test_cpu_renders_take_the_eager_path():
    r, samples = small_frame()
    before = dict(CW.GRAPHS)
    img, nrays = r.render_with_samples(samples, return_rays=True)
    eager, eager_rays = render_from_samples(r.scene, r.cfg, samples,
                                            return_rays=True)
    assert torch.equal(img, eager) and int(nrays) == int(eager_rays)
    assert CW.GRAPHS == before and r._graphs.tables is None
    spans.collect()
    spans.enable()
    try:
        r.render_with_samples(samples)
    finally:
        spans.disable()
    rec = spans.collect()
    names = {s["name"] for s in rec["spans"]}
    assert "whitted.level" in names and "whitted.graph" not in names
    assert not {c["name"] for c in rec["counts"]} & {
        "whitted.graph_captures", "whitted.graph_replays"}


class _Replay:
    def replay(self):
        pass


def test_a_full_and_one_short_tile_graph_are_kept(monkeypatch):
    """At most two graphs for each "rays counted": the full tile's, and
    the last short length's, which a new short length replaces."""
    r, _ = small_frame()
    captured = []

    def capture(self, scene, cfg, rays, counting):
        n = rays[0].shape[0]
        captured.append((n, counting))
        stats = {k: torch.zeros((), dtype=torch.int64)
                 for k in ("rays_traced", "shadow_rays")} if counting else {}
        return RD._Graph(_Replay(), tuple(x.clone() for x in rays),
                         torch.full((n, 3), float(n)), stats, n)

    monkeypatch.setattr(TileGraphs, "_capture", capture)
    g = TileGraphs()
    g.prepare(r.scene, r.cfg)
    for n, full, counting in ((8, True, False), (3, False, False),
                              (8, True, False), (3, False, False),
                              (5, False, False), (8, True, False),
                              (5, False, False), (8, True, True),
                              (3, False, True)):
        out, stats = g.trace(r.scene, r.cfg, _rays(r, n=n),
                             torch.empty((n, 3)), counting, full)
        assert torch.equal(out, torch.full((n, 3), float(n)))
    assert captured == [(8, False), (3, False), (5, False), (8, True),
                        (3, True)]
    assert {k: v.inputs[0].shape[0] for k, v in g._graphs.items()} == {
        (True, False): 8, (False, False): 5, (True, True): 8,
        (False, True): 3}


def test_trace_whitted_reads_the_callers_k3_tables():
    """The frame builds them once for its tiles
    (``test_torch_trace.py::test_level_tables_are_built_once_a_tile``)."""
    r, _ = small_frame()
    o, d, t, ls = _rays(r)
    with pytest.raises(ValueError, match="K3 tables"):
        trace_whitted(r.scene, r.cfg, o, d, t, ls)
    color, _ = trace_whitted(r.scene, r.cfg, o, d, t, ls,
                             tables=CW.level_tables(r.scene))
    assert color.shape == (8, 3)


@pytest.mark.parametrize("depth", [0, 2, 4])
def test_tree_nodes_are_the_lanes_counted_a_sample(depth):
    r, samples = small_frame()
    cfg = r.cfg.replace(max_depth=depth)
    spans.collect()
    spans.enable()
    try:
        render_from_samples(r.scene, cfg, samples)
    finally:
        spans.disable()
    lanes = sum(c["n"] for c in spans.collect()["counts"]
                if c["name"] == "whitted.lanes")
    assert lanes == 24 * 16 * tree_nodes(r.scene, cfg)
    assert tree_nodes(r.scene, cfg) == 2 ** (depth + 1) - 1


def test_paused_records_nothing_on_its_own_thread():
    spans.collect()
    spans.enable()
    other = []

    def elsewhere():
        with spans.span("b.outer"):
            spans.count("b.n", 2)
        other.append(spans.enabled())

    try:
        with spans.span("a.outer"):
            with spans.paused():
                assert not spans.enabled()
                with spans.paused():
                    pass
                assert not spans.enabled()
                with spans.span("a.hidden"):
                    spans.count("a.hidden", 1)
                    spans.count_device("a.device",
                                       torch.ones((), dtype=torch.int64))
                t = threading.Thread(target=elsewhere)
                t.start()
                t.join(timeout=30)
            assert spans.enabled()
            spans.count("a.n", 1)
    finally:
        spans.disable()
    rec = spans.collect()
    assert sorted(s["name"] for s in rec["spans"]) == ["a.outer", "b.outer"]
    assert sorted(c["name"] for c in rec["counts"]) == ["a.n", "b.n"]
    assert other == [True]
