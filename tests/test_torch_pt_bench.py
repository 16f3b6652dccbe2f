"""The benchmark's plain reference path tracer (``portbench.reference.pt``)
against the port's ``render_pt`` on the CPU, its scene 0 tables against
the port's, K6's count of two spheres by hand, and the path tracer's spans
and counters."""

import numpy as np
import pytest
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator import pathtracer as PT
from distributionraytracer_tpu_torch.scene import pt_scenes as PS
from distributionraytracer_tpu_torch.utils import spans
from portbench import roofline, roofline_pt
from portbench.reference import pt as ref
from portbench.reference import pt_scene

torch.set_num_threads(1)

H, W, S, BOUNCES = 16, 24, 4, 10
EYE, AT = [6.0, 1.6, -6.0], [0.0, 0.5, 0.0]
# Pixels (of 384) that may part by more than GAP.  The reference and the
# plain K6 round differently in the last bit (a normal renormalised, a
# distance taken as sqrt or through rsqrt); a Blinn exponent of up to
# 8 / 0.001 - 2 = 7998 (roughness 0) multiplies such an error in N.H
# some 8000-fold, and a roulette, branch or closest-hit decision that the
# rounding flips sends a path elsewhere, moving its pixel by up to the
# path's whole radiance over S.
FLIP_BUDGET = 2
GAP = 1e-4


def _samples(seed):
    g = torch.Generator().manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g)
    R = H * W * S
    return (u(H, W, S, 2), u(H, W, S),
            ref.Uniforms(u(BOUNCES, R, 2), u(BOUNCES, R), u(BOUNCES, R, 3),
                         u(BOUNCES, R, 3), u(BOUNCES, R)))


def _variant(seed):
    """Scene 0's leaves with the spheres moved and every material redrawn
    (diffuse, metal or dielectric; a tenth of them emissive)."""
    leaves = {k: v.copy() for k, v in pt_scene.scene0_leaves().items()}
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    for c in ("sph_center", "msph_c0"):
        shift = np.zeros_like(leaves[c])
        shift[:, [0, 2]] = rng.uniform(-0.3, 0.3, (shift.shape[0], 2))
        leaves[c] = f32(leaves[c] + shift)
        if c == "msph_c0":
            leaves["msph_c1"] = f32(leaves["msph_c1"] + shift)
    K = leaves["mat_type"].shape[0]
    leaves["mat_type"] = rng.integers(0, 3, K).astype(np.int32)
    for k in ("mat_albedo", "mat_spec"):
        leaves[k] = f32(rng.uniform(0.0, 1.0, (K, 3)))
    leaves["mat_rough"] = f32(rng.uniform(0.0, 1.0, K))
    leaves["mat_refidx"] = f32(rng.uniform(1.1, 1.9, K))
    leaves["mat_refract"] = f32(rng.uniform(0.0, 0.5, (K, 3)))
    leaves["mat_emissive"] = f32(rng.uniform(0.0, 1.5, (K, 3))
                                 * (rng.random(K) < 0.1)[:, None])
    return leaves


def _scenes(variant):
    """(the port's scene, the reference's) of scene 0 or a variant."""
    if variant is None:
        return PS.scene0(), pt_scene.PTRefScene(pt_scene.scene0_leaves(),
                                                "cpu")
    leaves = _variant(variant)
    port = PS.pt_scene_from_numpy(
        dict(leaves, sky_faces=np.zeros((6, 1, 1, 3), np.float32),
             sky_res=np.ones((6, 2), np.int32)), PS.SKY_GRADIENT)
    return port, pt_scene.PTRefScene(leaves, "cpu")


def _port_frame(scene, drawn, cfg=RenderConfig(max_bounces=BOUNCES)):
    jitter, times, uni = drawn
    return PT.render_pt(scene, cfg, W, H, eye=EYE, at=AT, spp=S,
                        samples=PT.PTSamples(jitter, times,
                                             PT.BounceUniforms(*uni)))


def _ref_frame(rs, drawn, counts=None):
    return ref.render(rs, ref.Camera(EYE, AT, 60.0, W, H), *drawn, BOUNCES,
                      counts=counts)


def test_reference_scene0_tables_are_the_ports():
    port = PS.scene0()
    rs = pt_scene.PTRefScene(pt_scene.scene0_leaves(), "cpu")
    assert set(PS.PTScene._LEAVES) - set(pt_scene.LEAVES) == {
        "sky_faces", "sky_res"}
    for k in pt_scene.LEAVES:
        a, b = getattr(rs, k), getattr(port, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert port.sky_mode == PS.SKY_GRADIENT and rs.sky == "gradient"
    assert rs.counts == (2, 78, 25)


@pytest.mark.parametrize("variant", [None, 0, 1, 2])
def test_render_pt_matches_the_reference(variant):
    port, rs = _scenes(variant)
    drawn = _samples(100 + (variant or 0))
    got = _port_frame(port, drawn)
    want = _ref_frame(rs, drawn)
    gap = (got - want).abs().amax(-1)
    assert int((gap > GAP).sum()) <= FLIP_BUDGET, gap.max()


def test_the_reference_in_bfloat16_differs():
    drawn = _samples(7)
    want = _ref_frame(pt_scene.PTRefScene(pt_scene.scene0_leaves(), "cpu"),
                      drawn)
    low = _ref_frame(pt_scene.PTRefScene(pt_scene.scene0_leaves(), "cpu",
                                         torch.bfloat16), drawn)
    assert float((low.float() - want).abs().mean()) > 1e-2


def test_the_reference_refuses_what_scene0_lacks():
    leaves = pt_scene.scene0_leaves()
    leaves["mat_type"] = leaves["mat_type"].copy()
    leaves["mat_type"][3] = pt_scene.PLASTIC
    rs = pt_scene.PTRefScene(leaves, "cpu")
    with pytest.raises(ValueError, match="plastic"):
        _ref_frame(rs, _samples(1))


def _two_spheres():
    """Sphere B at (0, 1, -3) r 0.3 (primitive 0), sphere A at (0, 0, -5)
    r 1 (primitive 1), one point light at (0, 4, 0), no triangles."""
    z3 = np.zeros((0, 3), np.float32)
    leaves = dict(
        tri_v0=z3, tri_e1=z3, tri_e2=z3, tri_mat=np.zeros(0, np.int32),
        sph_center=np.array([[0, 1, -3], [0, 0, -5]], np.float32),
        sph_radius=np.array([0.3, 1.0], np.float32),
        sph_mat=np.array([0, 0], np.int32),
        msph_c0=z3, msph_c1=z3, msph_radius=np.zeros(0, np.float32),
        msph_mat=np.zeros(0, np.int32),
        mat_type=np.zeros(1, np.int32),
        mat_albedo=np.full((1, 3), 0.5, np.float32),
        mat_spec=np.zeros((1, 3), np.float32),
        mat_emissive=np.zeros((1, 3), np.float32),
        mat_rough=np.ones(1, np.float32), mat_refidx=np.ones(1, np.float32),
        mat_refract=np.zeros((1, 3), np.float32),
        mat_stripe=np.zeros(1, bool),
        plight_pos=np.array([[0, 4, 0]], np.float32),
        plight_color=np.ones((1, 3), np.float32),
        qlight_pos=z3, qlight_color=z3, qlight_e1=z3, qlight_e2=z3)
    return pt_scene.PTRefScene(leaves, "cpu")


def test_k6_counts_of_two_spheres_by_hand():
    """Path 1 (to -z) passes B, 1 from its axis (20), hits A at (0, 0,
    -4) (28), its fold's d.d (5); its shadow ray to the light faces it and
    is stopped by B, the first primitive (28), d.d (5).  Path 2 misses
    both (20 + 20 + 5) and casts no shadow ray."""
    rs = _two_spheres()
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, -1.0], [0.70710677, 0.0, -0.70710677]])
    half = torch.full((1, 2), 0.5)
    uni = ref.Uniforms(half[:, :, None].expand(1, 2, 2), half, half[
        :, :, None].expand(1, 2, 3), half[:, :, None].expand(1, 2, 3),
        torch.zeros((1, 2)))
    counts = {}
    ref.trace(rs, o, d, torch.zeros(2), uni, 1, counts=counts)
    c = counts[0]
    assert c == {"paths": 2, "folds": 3, "tri": 0, "sph": 2, "sph_miss": 3,
                 "msph": 0, "msph_miss": 0}
    assert roofline_pt.ops(c) == 28 + 20 + 5 + 20 + 20 + 5 + 28 + 5
    nbytes = 4 * (2 * (20 + 20 + 8) + 2 * (12 + 16) + 6)
    assert roofline_pt.k6_bound_s(counts, 2, 1) == max(
        nbytes / roofline.MEM_BPS, 131 / roofline.FP32_OPS)


def _recorded(body):
    drawn = _samples(3)
    scene = PS.scene0()
    queries = PT.kernel_queries(scene) if body == "staged" else None
    cfg = RenderConfig(max_bounces=4, pt_tile_rays=700)
    jitter, times, uni = drawn
    uni = PT.BounceUniforms(*(x[:4] for x in uni))

    def frame():
        return PT.render_pt(scene, cfg, W, H, eye=EYE, at=AT, spp=S,
                            samples=PT.PTSamples(jitter, times, uni),
                            queries=queries)
    off = frame()
    spans.collect()
    spans.enable()
    try:
        on = frame()
        rec = spans.collect()
    finally:
        spans.disable()
        spans.collect()
    return off, on, rec


@pytest.mark.parametrize("body", ["fused", "staged"])
def test_pt_spans_nest_and_leave_the_frame_bit_equal(body):
    off, on, rec = _recorded(body)
    assert torch.equal(off, on)
    by_id = {s["id"]: s for s in rec["spans"]}
    names = lambda n: [s for s in rec["spans"] if s["name"] == n]
    parent = lambda s: by_id[s["parent"]]["name"]
    tiles = -(-H * W * S // 700)
    assert len(names("pt.frame")) == 1 and len(names("pt.tile")) == tiles
    assert all(parent(s) == "pt.frame" for s in names("pt.tile"))
    # the fused body's bounces are one pt_trace call a tile
    assert len(names("pt.bounce")) == (4 * tiles if body == "staged"
                                       else tiles)
    assert all(parent(s) == "pt.tile" for s in names("pt.bounce"))
    inner = names("pt.intersect")
    assert all(parent(s) == "pt.bounce" for s in inner)
    assert len(inner) == (4 * 4 * tiles if body == "staged" else 0)
    counts = {c["name"]: c["n"] for c in rec["counts"]}
    assert counts["pt.paths"] == 4 * H * W * S
    assert 0 < counts["pt.paths_live"] <= counts["pt.paths"]
    # the staged body's queries hold the tables they were built with
    assert counts.get("tables.builds.pt_tables", 0) == (body == "fused")


def test_pt_spans_record_nothing_when_off():
    spans.collect()
    drawn = _samples(4)
    _port_frame(PS.scene0(), drawn, RenderConfig(max_bounces=2))
    assert spans.collect() == {"spans": [], "counts": []}
