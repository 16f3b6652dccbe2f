"""The benchmark's path-tracer viewer cell on the CPU at small sizes: the
reference of the viewer's accumulator (``portbench.reference.pt_viewer``)
against the port's ``PTViewerState``, the ``pt.draws`` counter, the
cell's traffic kind, cameras and control, and the ``pt.draws.request``
reader."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator import pathtracer as PT
from distributionraytracer_tpu_torch.scene import pt_scenes as PS
from distributionraytracer_tpu_torch.utils import spans
from distributionraytracer_tpu_torch.utils.image import png_bytes
from distributionraytracer_tpu_torch.viewer import PTViewerState
from portbench import harness
from portbench.reference import png
from portbench.reference import pt_scene
from portbench.reference import pt_viewer as ref
from portbench.traffic import pt_viewer as tview

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, TILE = 24, 32, 300
# Pixels (of 768) whose byte may part by more than 2: the reference and
# the plain K6 round differently in the last bit, and a roulette, branch
# or closest-hit decision that the rounding flips sends a path elsewhere
# (as tests/test_torch_pt_bench.py's FLIP_BUDGET).
FLIP_BUDGET = 2


def _cell():
    cfg = dict(harness.load_json("configs", "pt_scene0.json"), res_x=W,
               res_y=H)
    return cfg, harness.load_json("workloads", "pt0.view.json")["params"]


def _every_pixel():
    rows, cols = torch.meshgrid(torch.arange(H), torch.arange(W),
                                indexing="ij")
    return rows.reshape(-1), cols.reshape(-1)


def test_the_reference_accumulates_the_viewers_frames():
    cfg, p = _cell()
    seed = 123456789
    state = PTViewerState(0, RenderConfig(max_bounces=cfg["max_bounces"],
                                          russian_roulette=True,
                                          pt_tile_rays=TILE),
                          res=(W, H), device="cpu", seed=seed)
    rs = pt_scene.ref_scene(cfg, "cpu")
    pick = _every_pixel()
    cams = [(30.0, 12.0, 8.86), (30.0, 12.0, 8.86), (-15.0, 5.0, 8.86)]
    # request k accumulates from the camera's first request
    firsts = [0, 0, 2]
    for k, (cam, first) in enumerate(zip(cams, firsts)):
        rgb, n = state.frame(*cam, True)
        assert n == k - first + 1
        want = png.to_u8(ref.accumulator(rs, cfg, p["orbit"], cam, seed,
                                         first, k, pick, TILE))
        got = rgb[pick[0].numpy(), pick[1].numpy()].astype(np.int32)
        diff = np.abs(got - want.astype(np.int32)).max(-1)
        assert (diff > 2).sum() <= FLIP_BUDGET, (k, (diff > 2).sum())
        assert np.median(diff) == 0
        # the PNG the server sends holds the same bytes, top row first
        assert np.array_equal(tview.pixels_of(png_bytes(rgb), pick), got)


def test_the_reference_draws_are_the_programs():
    cfg, _ = _cell()
    scene = PS.scene0()
    g = torch.Generator().manual_seed((77 << 32) + 5)
    jitter = torch.rand((H, W, 1, 2), generator=g)
    times = torch.rand((H, W, 1), generator=g)
    R = H * W
    tiles = [PT.draw_bounces(scene, min(a + TILE, R) - a,
                             cfg["max_bounces"], g, "cpu")
             for a in range(0, R, TILE)]
    rj, rt, ru = ref.draws(77, 5, H, W, 1, cfg["max_bounces"], TILE, "cpu")
    assert torch.equal(rj, jitter) and torch.equal(rt, times)
    for k, name in enumerate(ru._fields):
        assert torch.equal(ru[k], torch.cat([t[k] for t in tiles], 1)), name


def _draws(fn):
    spans.collect()
    spans.enable()
    try:
        fn()
        rec = spans.collect()
    finally:
        spans.disable()
        spans.collect()
    return sum(c["n"] for c in rec["counts"] if c["name"] == "pt.draws")


@pytest.mark.parametrize("kernels", ["auto", "off"])
def test_pt_draws_counts_every_generator_draw(kernels):
    scene = PS.scene0()
    B = 3
    cfg = RenderConfig(max_bounces=B, russian_roulette=True,
                       pt_tile_rays=TILE, kernels=kernels)
    g = torch.Generator().manual_seed(9)
    n = _draws(lambda: PT.render_pt(scene, cfg, W, H, g, spp=1))
    tiles = -(-H * W // TILE)
    assert n == 2 + tiles * B * 5
    # injected numbers: nothing drawn
    s = PT.PTSamples(torch.rand((H, W, 1, 2)), torch.rand((H, W, 1)),
                     PT.BounceUniforms(*(torch.rand((B, H * W) + sh)
                                         for sh in ((2,), (), (3,), (3,),
                                                    ()))))
    assert _draws(lambda: PT.render_pt(scene, cfg, W, H, spp=1,
                                       samples=s)) == 0


def test_pt_draws_leaves_the_image():
    scene = PS.scene0()
    cfg = RenderConfig(max_bounces=4, pt_tile_rays=TILE)
    off = PT.render_pt(scene, cfg, W, H, torch.Generator().manual_seed(4))
    spans.enable()
    try:
        on = PT.render_pt(scene, cfg, W, H, torch.Generator().manual_seed(4))
    finally:
        spans.disable()
        spans.collect()
    assert torch.equal(on, off)


def test_cameras_visit_every_position_for_a_run_of_requests():
    _, p = _cell()
    every, offs = p["moves_every"], p["camera_offsets_deg"]
    for seed in (1, 2**35 + 3):
        cams = tview.cameras(seed, p["orbit"], offs, every, every * 8)
        runs = [cams[i:i + every] for i in range(0, len(cams), every)]
        assert all(len(set(r)) == 1 for r in runs)
        got = sorted((round(a - 45.0, 3), round(b - 10.0, 3))
                     for (a, b, _), *_ in runs)
        assert got == sorted((float(a), float(b)) for a, b in offs)
        # every position stands above the ground (y = -0.05)
        for (a, b, r), *_ in runs:
            assert ref.eye(p["orbit"]["at"], a, b, r)[1] > 0.5


SMALL = {"res_x": W, "res_y": H,
         "params": {"check_pixels": 256, "tile_paths": TILE}}


def test_the_cell_runs_small_and_is_correct():
    from portbench import run

    ctx = harness.Context("pt0.view", 2**40 + 31, 1.0, 0, device="cpu",
                          overrides=SMALL)
    out = run.run_cell(ctx)
    assert out.checks.correct, out.checks.lines()
    assert out.attempted >= 2 and out.failed == 0
    assert set(out.end_to_end) == {"request_ms_p95", "setup_s"}


def test_the_control_and_faults_fail():
    from portbench import control_pt_viewer

    ctx = harness.Context("pt0.view", 2**40 + 32, 0, 0, device="cpu",
                          overrides=dict(SMALL, params={"check_pixels": 768,
                                                        "tile_paths": TILE}))
    got = control_pt_viewer.readings(ctx)
    assert set(got) == {"control", "stale_accumulator", "one_bounce_fewer",
                        "no_boost"}
    for name in ("control", "stale_accumulator", "no_boost"):
        assert not got[name].correct, (name, got[name].lines())


def test_compare_reads_a_body_that_is_no_png_as_nan():
    checks = tview.compare([(tview.pixels_of(b"nope", _every_pixel()),
                             np.zeros((H * W, 3), np.float32))],
                           {"bad_px": 0.01, "mean_abs": 5e-4})
    assert not checks.correct
    assert all(v != v for v in checks.numbers().values())


def test_pt_draws_reader():
    rd = harness.readers()["pt.draws.request"]
    prog = {"unit": "request", "counts": {"pt.draws": 202.0}}
    assert rd.read({"program": prog}) == 202.0
    assert rd.read({"program": dict(prog, counts={})}) is None
    assert rd.read({"program": dict(prog, unit="frame")}) is None
    assert rd.read({}) is None
    assert rd.UNIT == "calls"


def test_the_cell_is_declared():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = next(w for w in bench["workloads"] if w["name"] == "pt0.view")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "pt_scene0", "view", 1)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "pt0.view" in e2e["request_ms_p95"]["workloads"]
    names = [m["name"] for m in bench["per_layer"]]
    first = names.index("kernel.grid_roofline")
    assert names[first:first + 3] == ["kernel.grid_roofline",
                                      "grid.gate_ms.frame",
                                      "pt.draws.request"]


def test_the_viewer_reference_loads_nothing_of_the_program():
    code = ("import json, sys\n"
            "import portbench.reference.pt_viewer\n"
            "import portbench.control_pt_viewer\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules"
            " if m.split('.')[0].startswith(('distributionraytracer',"
            " 'jax', 'flax'))})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
