"""The port's span and counter recorder (``utils/spans.py``) and the spans and
counters inside the port: off, it records nothing and changes no frame;
on, spans nest per thread and unit, the ray counters add up to the
``return_rays`` count, table packings are counted where they happen, and
the stamps share ``torch.profiler``'s clock.  CPU only; no JAX."""

import threading
import time
import urllib.request

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributionraytracer_tpu_torch import viewer as V
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import make_samples
from distributionraytracer_tpu_torch.renderer import Renderer, build_accel
from distributionraytracer_tpu_torch.scene import SceneBuilder
from distributionraytracer_tpu_torch.scene.procedural import (
    create_random_scene,
)
from distributionraytracer_tpu_torch.utils import spans

from torch_scenes import mesh_scene

torch.set_num_threads(1)


@pytest.fixture
def recorder():
    """The recorder, on and empty; off and empty again afterwards."""
    spans.collect()
    spans.enable()
    yield spans
    spans.disable()
    spans.collect()


class Ops(TorchDispatchMode):
    """Records every aten op dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((func, args))
        return func(*args, **(kwargs or {}))


def random_frame(tile_rays=256):
    scene = create_random_scene(0, 24, 16)
    cfg = RenderConfig(spp=1, tile_rays=tile_rays)
    r = Renderer(scene, cfg, device="cpu")
    samples = make_samples(r.scene, cfg, torch.Generator().manual_seed(3))
    return r, samples


def mesh_frame():
    scene = mesh_scene(SceneBuilder, n_tri=2000, accel=2, res=(16, 16))
    r = Renderer(scene, RenderConfig(spp=0), device="cpu")
    samples = make_samples(r.scene, r.cfg)
    return r, samples


def by_name(records, name):
    return [s for s in records["spans"] if s["name"] == name]


def counts(records, unit=None):
    out = {}
    for c in records["counts"]:
        if unit is None or c["unit"] == unit:
            out[c["name"]] = out.get(c["name"], 0) + c["n"]
    return out


def test_off_the_sites_run_no_op_and_record_nothing():
    spans.disable()
    spans.collect()
    t = torch.ones(4, dtype=torch.bool)
    with Ops() as mode:
        a, b = spans.span("x"), spans.span("y")
        with a:
            spans.count("c", 3)
            spans.count_device("d", t.sum())
            spans.host_read(t)
    assert a is b  # one shared no-op: nothing allocated a span
    assert [f for f, _ in mode.ops] == [torch.ops.aten.sum.default]  # t.sum()
    assert spans.collect() == {"spans": [], "counts": []}


@pytest.mark.parametrize("frame", [random_frame, mesh_frame],
                         ids=["random", "mesh"])
def test_frames_are_bitwise_equal_on_and_off(frame):
    r, samples = frame()
    spans.disable()
    off = r.render_with_samples(samples)
    assert spans.collect() == {"spans": [], "counts": []}
    spans.enable()
    try:
        on = r.render_with_samples(samples)
    finally:
        spans.disable()
    rec = spans.collect()
    assert torch.equal(off, on)
    assert len(by_name(rec, "render.frame")) == 1
    assert counts(rec)["whitted.lanes_live"] > 0


def _bool_sums(mode):
    return sum(1 for f, args in mode.ops if f in (
        torch.ops.aten.sum.default, torch.ops.aten.sum.dim_IntList)
        and args[0].dtype == torch.bool)


def test_rays_are_counted_only_when_read(recorder):
    r, samples = random_frame()
    recorder.disable()
    with Ops() as off:
        r.render_with_samples(samples)
    with Ops() as asked:
        _, nrays = r.render_with_samples(samples, return_rays=True)
    recorder.enable()
    with Ops() as on:
        r.render_with_samples(samples)
    rec = recorder.collect()
    levels = len(by_name(rec, "whitted.level"))
    assert levels == 5 * len(by_name(rec, "render.tile"))
    assert _bool_sums(off) == 0  # nothing launched to count rays
    assert _bool_sums(asked) == _bool_sums(on) == 2 * levels
    assert nrays.dtype == torch.int64


def test_spans_nest_and_share_the_frames_unit(recorder):
    r, samples = random_frame()
    r.render_with_samples(samples)
    r.render_with_samples(samples)
    rec = recorder.collect()
    frames = by_name(rec, "render.frame")
    assert len(frames) == 2 and frames[0]["unit"] != frames[1]["unit"]
    ids = {s["id"]: s for s in rec["spans"]}
    parent_of = {"render.frame": None, "render.tile": "render.frame",
                 "whitted.level": "render.tile",
                 "whitted.intersect": "whitted.level",
                 "whitted.combine": "render.tile"}
    for s in rec["spans"]:
        p = ids.get(s["parent"])
        assert (None if p is None else p["name"]) == parent_of[s["name"]]
        if p is not None:
            assert p["unit"] == s["unit"]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    units = {f["unit"] for f in frames}
    assert {s["unit"] for s in rec["spans"]} == units
    assert {c["unit"] for c in rec["counts"]} == units


def test_a_second_threads_spans_do_not_nest_under_the_first(recorder):
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait(timeout=30)
        with spans.span("b.outer"):
            with spans.span("b.inner"):
                spans.count("b.n", 2)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with spans.span("a.outer"):
        spans.count("a.n", 1)
        inside.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    rec = recorder.collect()
    s = {x["name"]: x for x in rec["spans"]}
    assert s["b.outer"]["parent"] is None
    assert s["b.inner"]["parent"] == s["b.outer"]["id"]
    assert s["b.outer"]["unit"] != s["a.outer"]["unit"]
    assert s["b.outer"]["thread"] != s["a.outer"]["thread"]
    assert counts(rec, s["b.outer"]["unit"]) == {"b.n": 2}
    assert counts(rec, s["a.outer"]["unit"]) == {"a.n": 1}


@pytest.mark.parametrize("frame", [random_frame, mesh_frame],
                         ids=["random", "mesh"])
def test_live_lanes_and_shadow_rays_are_the_return_rays_count(recorder,
                                                              frame):
    r, samples = frame()
    recorder.disable()
    _, nrays = r.render_with_samples(samples, return_rays=True)
    recorder.enable()
    r.render_with_samples(samples)
    c = counts(recorder.collect())
    assert c["whitted.lanes_live"] + c["whitted.shadow_rays"] == int(nrays)
    assert 0 < c["whitted.lanes_live"] <= c["whitted.lanes"]


def test_level_tables_are_built_once_a_tile(recorder):
    """The counters count each build of the K3 tables: once for all the
    tiles of a CPU (eager) frame."""
    r, samples = random_frame(tile_rays=100)
    r.render_with_samples(samples)
    rec = recorder.collect()
    tiles = len(by_name(rec, "render.tile"))
    assert tiles == -(-24 * 16 // 100)
    c = counts(rec)
    assert c["tables.builds.level_tables"] == 1
    assert c["tables.builds.pack_whitted_mats"] == 1
    assert c["tables.builds.packed_objects"] == 2
    assert "sync.host_reads" not in c  # the CPU has no card to read


def test_bins_and_accel_build_spans(recorder):
    r, samples = mesh_frame()
    r.render_with_samples(samples)
    r.render_with_samples(samples)
    rec = recorder.collect()
    assert len(by_name(rec, "render.bins")) == 2
    assert counts(rec)["bins.primary_builds"] == 1  # the second is cached
    # the Renderer's frame tables: one block order for both frames
    assert counts(rec)["tables.builds.block_perm"] == 1
    assert counts(rec)["tables.builds.frame_tables"] == 1
    ab = build_accel(r.scene.to("cpu"))
    (sp,) = by_name(recorder.collect(), "accel.build")
    assert ab.seconds == (sp["end_ns"] - sp["start_ns"]) / 1e9
    recorder.disable()
    assert build_accel(r.scene.to("cpu")).seconds > 0.0  # timed when off


def test_viewer_request_phases(recorder):
    httpd = V.make_server(create_random_scene(0, 16, 12), RenderConfig(),
                          port=0, device="cpu")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/frame?alpha=10"
        with urllib.request.urlopen(url, timeout=60) as resp:
            assert resp.status == 200 and resp.read()[:4] == b"\x89PNG"
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    assert not server.is_alive()
    rec = recorder.collect()
    (req,) = by_name(rec, "viewer.request")
    kids = [s["name"] for s in rec["spans"] if s["parent"] == req["id"]]
    assert sorted(kids) == sorted(["viewer.wait", "viewer.render",
                                   "viewer.png", "viewer.send"])
    (frame,) = by_name(rec, "render.frame")
    assert frame["unit"] == req["unit"]


def busy(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_span_stamps_enclose_the_profilers_events(recorder):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(50):
            with spans.span("mm"):
                busy(20e-6)  # margins far below a span's length in a frame
                a @ a
                busy(20e-6)
            time.sleep(1e-4)  # apart, so each event has one span around it
    mm = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                if e.name() == "aten::mm"
                and e.device_type() == DeviceType.CPU)
    mm_end = sorted(e.end_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "aten::mm"
                    and e.device_type() == DeviceType.CPU)
    sp = sorted((s["start_ns"], s["end_ns"])
                for s in by_name(recorder.collect(), "mm"))
    assert len(mm) == len(sp) == 50
    for (s0, s1), e0, e1 in zip(sp, mm, mm_end):
        assert s0 <= e0 and e1 <= s1
