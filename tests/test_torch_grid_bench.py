"""The benchmark's sphereflake on the uniform grid, on the CPU at small
sizes: the frozen generator (``portbench/scenes/sphereflake.py``), the
grid reference (``portbench.reference.grid``) against the port's grid
routes, the grid's two gates on hand-built rays in both, the cull of the
reference's sphere pairs, the ``accel.grid_gate`` span and
``grid.gate_rays`` count, the cell's traffic kind and control, and the
readers ``kernel.grid_roofline`` and ``grid.gate_ms.frame``."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributionraytracer_tpu_torch.accel.cuda_grid import (
    make_cuda_grid_intersectors,
)
from distributionraytracer_tpu_torch.utils import spans
from portbench import harness, program, samples
from portbench.reference import grid as ref
from portbench.reference import scene as rscene
from portbench.reference import whitted
from portbench.scenes import sphereflake as flake

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(size=2, res=24, **kw):
    return dict(harness.load_json("configs", "balls_high_grid.json"),
                size_factor=size, res_x=res, res_y=res, **kw)


def _parents(size):
    """Parent row of each row of ``flake.spheres(size)`` (-1 the root)."""
    sub = [1]
    for _ in range(size):
        sub.append(1 + 9 * sub[-1])
    out = [-1] * sub[size]

    def walk(i, k):
        at = i + 1
        for _ in range(9 if k else 0):
            out[at] = i
            walk(at, k - 1)
            at += sub[k - 1]

    walk(0, size)
    return np.array(out)


# ---------------------------------------------------------------- the scene
@pytest.mark.parametrize("size,spheres", [(1, 10), (2, 91), (4, 7381)])
def test_sphere_counts(size, spheres):
    sc = program.scene(_cfg(size))
    types = np.array(sc.static.obj_types)
    assert (types == 0).sum() == spheres
    assert sc.static.n_objects == spheres + 2
    assert len(flake.spheres(size)) == spheres


def test_the_configuration_states_the_full_flake():
    cfg = harness.load_json("configs", "balls_high_grid.json")
    sc = program.scene(cfg)
    assert sc.static.n_objects == cfg["objects"] == 7383
    assert int(sc.sph_radius.shape[0]) == cfg["spheres"]
    assert (sc.static.res_x, sc.static.res_y, sc.static.accel) == (512, 512,
                                                                   1)
    assert sc.light_pos.shape[0] == cfg["lights"]


def test_root_and_first_child_as_spd_prints_them_turned_y_up():
    rows = flake.spd(flake.spheres(1))
    # SPD's output: "s 0.272166 0.272166 0.544331 0.166667"
    np.testing.assert_array_equal(rows[1], [0.272166, 0.272166, 0.544331,
                                            0.166667])
    sc = program.scene(_cfg(1))
    assert torch.equal(sc.sph_center[0], torch.zeros(3))
    assert float(sc.sph_radius[0]) == 0.5
    np.testing.assert_array_equal(sc.sph_center[1].numpy(), np.float32(
        [0.272166, 0.544331, -0.272166]))
    np.testing.assert_allclose(sc.cam_eye.numpy(), [2.1, 1.7, -1.3])
    np.testing.assert_allclose(sc.cam_up.numpy(), [0.0, 1.0, 0.0])
    # the ground square lies at y = -0.5 under the turn
    v0 = sc.tri_v0.numpy()
    assert np.all(v0[:, 1] == -0.5) and np.all(np.abs(v0[:, [0, 2]]) == 12)


@pytest.mark.parametrize("size", [2, 4])
def test_every_child_is_tangent_to_its_parent(size):
    rows = flake.spheres(size)
    par = _parents(size)
    kid = np.arange(1, len(rows))
    gap = (np.linalg.norm(rows[kid, :3] - rows[par[kid], :3], axis=1)
           - rows[kid, 3] - rows[par[kid], 3])
    assert np.abs(gap).max() < 1e-12
    assert np.allclose(rows[kid, 3], rows[par[kid], 3] / 3)
    # the six digits SPD prints keep them tangent to within rounding
    p = flake.spd(rows)
    gap = (np.linalg.norm(p[kid, :3] - p[par[kid], :3], axis=1)
           - p[kid, 3] - p[par[kid], 3])
    assert np.abs(gap).max() < 5e-6


def test_no_child_points_back_toward_its_parent():
    d = flake.objset()
    assert np.allclose(np.linalg.norm(d, axis=1), 1)
    assert (d[:, 2] >= -1e-12).all()  # a +z parent's children: none below


def test_the_reference_records_the_programs_arrays():
    cfg = _cfg(2)
    sc, rs = program.scene(cfg), rscene.ref_scene(cfg, "cpu")
    assert torch.equal(rs.sph_c, sc.sph_center)
    assert torch.equal(rs.sph_r, sc.sph_radius)
    assert torch.equal(rs.tri_v0, sc.tri_v0)
    assert torch.equal(rs.tri_e1, sc.tri_e1)
    assert torch.equal(rs.tri_e2, sc.tri_e2)
    assert torch.equal(rs.lights, sc.light_pos)
    assert torch.equal(rs.bg, sc.bg_color)
    assert rs.accel == sc.static.accel == 1 and rs.n_obj == 93


# ------------------------------------------------------ the port's frames
def _frames(cfg, degrees, route):
    sc = program.scene(cfg)
    rs = rscene.ref_scene(cfg, "cpu")
    eye = samples.orbit_eye(sc.cam_eye.numpy(), sc.cam_at.numpy(), degrees)
    sc = dataclasses.replace(sc, cam_eye=torch.as_tensor(eye))
    r = program.Renderer(sc, program.render_config(
        cfg, accel_cost_threshold=0), device="cpu")
    if route == "grid-packet":
        r._gbox = None  # no primary bins: K7 takes every level
    assert r.executed_backend() == route
    H = W = cfg["res_x"]
    pix = samples.centred(H, W, "cpu")
    half = torch.full((H, W, 1, 2), 0.5)
    ss = program.SampleSet(pixel=pix, light=half, lens=torch.zeros_like(half),
                           time=torch.zeros((H, W, 1)))
    got = r.render_with_samples(ss)
    want = ref.render(rs.with_eye(eye), pix, cfg["max_depth"])
    return got, want


@pytest.mark.parametrize("size,res,route", [
    (4, 16, "binned-primary+grid-packet"), (2, 24, "grid-packet")])
@pytest.mark.parametrize("degrees", [0.0, 129.0])
def test_the_port_matches_the_grid_reference(size, res, route, degrees):
    got, want = _frames(_cfg(size, res), degrees, route)
    diff = (got - want).abs()
    assert float((diff.amax(-1) > 0.02).float().mean()) == 0.0
    assert float(diff.mean()) < 1e-5
    assert float(got.std()) > 0.05  # the frame shows something


# ------------------------------------------------------------- the gates
def _grid_scene():
    cfg = _cfg(1, 8)
    sc = program.scene(cfg)
    r = program.Renderer(sc, program.render_config(cfg), device="cpu")
    return r, rscene.ref_scene(cfg, "cpu")


def test_a_shadow_ray_whose_slab_init_fails_is_shadowed_in_both():
    r, rs = _grid_scene()
    inter = make_cuda_grid_intersectors(r.scene, r.tabs)
    # from above the grid box: pointing up it leaves the box behind it
    # (t1 < 0), pointing down it enters it, and meets nothing within 1
    o = torch.tensor([[0.0, 20.0, 0.0], [0.0, 20.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    dist = torch.ones(2)
    got = inter.shadow(o, d, dist, torch.full((2,), -1))
    want = ref.occluded(rs, o, d, dist)
    assert got.tolist() == want.tolist() == [True, False]


def test_a_hit_past_the_grid_exit_is_dropped_in_both():
    r, rs = _grid_scene()
    # straight down onto the root sphere's top (t = 2.5 from y = 3)
    o, d = torch.tensor([[0.0, 3.0, 0.0]]), torch.tensor([[0.0, -1.0, 0.0]])
    inter = make_cuda_grid_intersectors(r.scene, r.tabs)
    h = inter.closest(o, d, torch.zeros(1))
    hit, t, *_ = ref.closest(rs, o, d)
    assert bool(h.hit[0]) and bool(hit[0])
    assert float(h.t[0]) == float(t[0]) == pytest.approx(2.5, abs=1e-6)
    # a grid box whose floor is at y = 1: the ray leaves it at t = 2
    lo = r.tabs.bbox_min.copy()
    lo[1] = 1.0
    cut = make_cuda_grid_intersectors(r.scene, r.tabs._replace(bbox_min=lo))
    rs._gbox = (torch.as_tensor(lo), ref.grid_box(rs)[1])
    h = cut.closest(o, d, torch.zeros(1))
    hit, *_ = ref.closest(rs, o, d)
    assert not bool(h.hit[0]) and int(h.obj_id[0]) == -1
    assert not bool(hit[0])


def test_the_grid_box_is_the_programs():
    r, rs = _grid_scene()
    lo, hi = ref.grid_box(rs)
    np.testing.assert_array_equal(lo.numpy(), r.tabs.bbox_min)
    np.testing.assert_array_equal(hi.numpy(), r.tabs.bbox_max)


def test_the_sphere_cull_drops_no_hit():
    cfg = _cfg(4, 8)
    rs = rscene.ref_scene(cfg, "cpu")
    g = torch.Generator().manual_seed(3)
    # origins on and around the flake, directions everywhere
    pick = torch.randint(0, rs.sph_c.shape[0], (1500,), generator=g)
    o = rs.sph_c[pick] + torch.randn((1500, 3), generator=g) * (
        rs.sph_r[pick, None] * 1.01)
    d = whitted.unit(torch.randn((1500, 3), generator=g))
    t, row = ref._sphere_min(rs, o, d)
    tm, _ = whitted.sphere_t(o, d, rs.sph_c, rs.sph_r)
    want_t = tm.min(1).values
    assert torch.equal(t, want_t)
    hit = torch.isfinite(want_t)
    first = (tm == want_t[:, None]).to(torch.int8).argmax(1)
    assert hit.sum() > 300
    assert torch.equal(row[hit], first[hit])
    # shadow rays of length 1: the cull keeps every occluder
    near = (tm < 1.0).any(1)
    occ = torch.zeros(1500, dtype=torch.bool)
    for ray, s in ref._sphere_pairs(rs, o, d, torch.ones(1500)):
        tt = ref.pair_t(o[ray], d[ray], rs.sph_c[s], rs.sph_r[s])
        occ[ray[tt < 1.0]] = True
    assert torch.equal(occ, near) and near.sum() > 100


def test_dot_products_sum_in_the_upstreams_order():
    g = torch.Generator().manual_seed(5)
    a, b = torch.randn((4096, 3), generator=g), torch.randn((4096, 3),
                                                           generator=g)
    want = (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]
    assert torch.equal(ref.dot(a, b), want)
    u = ref.unit(a)
    assert torch.equal(u, a / torch.sqrt(ref.dot(a, a))[:, None])
    assert torch.equal(ref.unit(torch.zeros(2, 3)), torch.zeros(2, 3))


# ------------------------------------------------------- spans and counts
def test_grid_gate_span_and_ray_count():
    cfg = _cfg(2, 16)
    sc = program.scene(cfg)
    r = program.Renderer(sc, program.render_config(
        cfg, accel_cost_threshold=0), device="cpu")
    H = W = 16
    half = torch.full((H, W, 1, 2), 0.5)
    ss = program.SampleSet(pixel=half, light=half, lens=torch.zeros_like(half),
                           time=torch.zeros((H, W, 1)))
    off = r.render_with_samples(ss)
    spans.collect()
    spans.enable()
    try:
        on, rays = r.render_with_samples(ss, return_rays=True)
        rec = spans.collect()
    finally:
        spans.disable()
        spans.collect()
    assert torch.equal(on, off)  # the recorder moves no pixel
    gates = [s for s in rec["spans"] if s["name"] == "accel.grid_gate"]
    counts = {}
    for c in rec["counts"]:
        counts[c["name"]] = counts.get(c["name"], 0) + c["n"]
    # one gate a query: a closest and a shadow query a tree level
    levels = cfg["max_depth"] + 1
    assert len(gates) == 2 * levels
    # every lane of a level goes through its closest gate, and through the
    # shadow gate once a light
    lights = int(sc.light_pos.shape[0])
    assert counts["grid.gate_rays"] == counts["whitted.lanes"] * (1 + lights)
    frame = next(s for s in rec["spans"] if s["name"] == "render.frame")
    assert all(g["unit"] == frame["unit"] for g in gates)


# -------------------------------------------------- the cell, end to end
SMALL = {"res_x": 24, "res_y": 24, "size_factor": 2,
         "params": {"check_pixels": 128}}


def test_the_cell_runs_small_and_is_correct():
    from portbench import run

    ctx = harness.Context("flake.turntable", 2**40 + 21, 0.3, 0,
                          device="cpu", overrides=SMALL)
    out = run.run_cell(ctx)
    assert out.checks.correct, out.checks.lines()
    assert out.attempted >= 1 and out.failed == 0
    assert set(out.end_to_end) == {"frame_ms", "setup_s"}
    assert out.obs["accel"] == "grid"


def test_the_control_and_faults_fail():
    from portbench import control_grid

    ctx = harness.Context("flake.turntable", 2**40 + 22, 0, 0, device="cpu",
                          overrides=dict(SMALL, size_factor=4,
                                         params={"check_pixels": 512}))
    got = control_grid.readings(ctx)
    assert set(got) == {"control", "stale_frame", "depth_3", "dark_light"}
    for name, checks in got.items():
        assert not checks.correct, (name, checks.lines())


def test_the_cell_and_configuration_are_declared():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = next(w for w in bench["workloads"]
                if w["name"] == "flake.turntable")
    own = harness.load_json("workloads", "flake.turntable.json")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        own["config"], own["traffic"], 1) == ("balls_high_grid",
                                              "turntable", 1)
    cfg = next(c for c in bench["configs"] if c["name"] == "balls_high_grid")
    assert cfg["reduced"] == []
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "flake.turntable" in e2e["frame_ms"]["workloads"]


# ------------------------------------------------------------- the readers
def _reader(name):
    return harness.readers()[name]


def test_grid_roofline_reader():
    rd = _reader("kernel.grid_roofline")
    prof = {"device": {"grouped_closest_kernel(float*)": [4, 0.003],
                       "closest_items_kernel": [1, 0.001],
                       "at::elementwise": [9, 0.5]}}
    assert rd.read({"profile": prof, "grid_floor_s": 0.0002}) == \
        pytest.approx(5.0)
    assert rd.read({"profile": prof}) is None
    assert rd.read({"profile": prof, "accel_floor_s": 0.0002}) is None
    assert rd.read({"grid_floor_s": 0.0002}) is None
    assert rd.read({"profile": {"device": {}}, "grid_floor_s": 1}) is None
    assert rd.UNIT == "%"


def test_grid_gate_ms_reader():
    rd = _reader("grid.gate_ms.frame")
    prog = {"unit": "frame", "span_ms": {"accel.grid_gate": 2.25}}
    assert rd.read({"program": prog}) == 2.25
    assert rd.read({"program": dict(prog, span_ms={})}) is None
    assert rd.read({"program": dict(prog, unit="request")}) is None
    assert rd.read({}) is None
    assert rd.UNIT == "ms"


def test_the_grid_reference_loads_nothing_of_the_program():
    code = ("import json, sys\n"
            "import portbench.reference.grid, portbench.control_grid\n"
            "import portbench.traffic.grid_frames\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules"
            " if m.split('.')[0].startswith(('distributionraytracer',"
            " 'jax', 'flax'))})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
