"""The reference against the program's plain route on tiny frames, and
the K3 operation and byte count of a two-sphere scene by hand."""

import pytest
import torch

from portbench import harness, program, roofline, samples
from portbench.reference import scene as rscene
from portbench.reference import whitted as ref


def _port_frame(cfg, pixel):
    r = program.Renderer(program.scene(cfg), program.render_config(cfg),
                         device="cpu")
    half = torch.full_like(pixel, 0.5)
    ss = program.SampleSet(pixel=pixel, light=half,
                           lens=torch.zeros_like(pixel),
                           time=torch.zeros(pixel.shape[:3]))
    return r.render_with_samples(ss, return_rays=True)


@pytest.mark.parametrize("name,over", [
    ("rtow_final", {"res_x": 24, "res_y": 16, "spp": 4}),
    ("dragon_mesh100k_bvh", {"res_x": 24, "res_y": 24, "n_triangles": 2000}),
])
def test_reference_matches_the_plain_route(name, over):
    cfg = dict(harness.load_json("configs", name + ".json"), **over)
    H, W, S = cfg["res_y"], cfg["res_x"], max(cfg["spp"], 1)
    pixel = (samples.stratified(11, H, W, S, "cpu") if cfg["spp"]
             else samples.centred(H, W, "cpu"))
    img, rays = _port_frame(cfg, pixel)
    counts = {}
    want = ref.render(rscene.ref_scene(cfg, "cpu"), pixel, cfg["max_depth"],
                      counts=counts)
    assert float((img - want).abs().max()) < 1e-4
    assert int(rays) == sum(c["rays"] + c["shadow_rays"]
                            for c in counts.values())
    low = ref.render(rscene.ref_scene(cfg, "cpu", torch.bfloat16), pixel,
                     cfg["max_depth"]).float()
    assert float((low - want).abs().mean()) > 1e-2


def test_k3_counts_of_two_spheres_by_hand():
    """Sphere A at (0, 0, -5) r 1 (object 0), sphere B at (0, 0.6, -4)
    r 0.3 (object 1), a light straight above A's nearest point.  Ray 1 (to
    -z) hits A (28), passes B at 0.6 > 0.3 (20), its fold's d.d (5); its
    shadow ray skips A and is stopped by B (28), d.d (5).  Ray 2 misses
    both (20 + 20 + 5)."""
    b = rscene.Recorder()
    b.set_camera([0, 0, 0], [0, 0, -1], [0, 1, 0], 40, 0.01, 4, 4, 0, 1)
    m = b.add_material([0.5, 0.5, 0.5], 1.0, [0, 0, 0], 0.0, 10, 0, 1)
    b.add_sphere([0, 0, -5], 1.0, m)
    b.add_sphere([0, 0.6, -4], 0.3, m)
    b.add_point_light([0, 10, -4], [1, 1, 1])
    rs = rscene.RefScene(b, "cpu")
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, -1.0], [0.70710677, 0.0, -0.70710677]])
    counts = {}
    ref.trace_rays(rs, o, d, max_depth=0, counts=counts)
    c = counts[0]
    assert (c["rays"], c["shadow_rays"]) == (2, 1)
    assert float(c["closest_ops"]) == 28 + 20 + 5 + 20 + 20 + 5
    assert float(c["shadow_ops"]) == 28 + 5
    nbytes = 2 * (44 + 16) + 2 * 104 + 40
    assert roofline.k3_bound_s(counts, 0, 2, 1) == max(
        nbytes / roofline.MEM_BPS, 131 / roofline.FP32_OPS)


def test_png_encode_and_decode_are_inverse():
    import numpy as np

    from portbench.reference import png

    rgb = np.random.default_rng(3).integers(0, 256, (5, 7, 3), np.uint8)
    assert (png.decode(png.encode(rgb)) == rgb).all()


def test_the_cells_comparisons_judge_alike_what_is_alike():
    import numpy as np
    import torch

    from portbench.traffic import frames, invert, viewer
    from portbench.reference import png

    img = torch.rand(6, 8, 3)
    assert frames.compare([(img, img)], {"bad_px": 0.0,
                                         "mean_abs": 0.0}).correct
    assert not frames.compare([(img + 0.05, img)], {"bad_px": 0.5,
                                                    "mean_abs": 1.0}).correct
    mean = np.random.default_rng(1).random((6, 8, 3), np.float32)
    body = png.encode(png.to_u8(mean)[::-1])
    lim = {"bad_px": 0.0, "mean_abs": 0.0}
    assert viewer.compare([(body, mean)], lim).correct
    assert not viewer.compare([(body, mean[::-1])], lim).correct
    assert not viewer.compare([(b"not a png", mean)], lim).correct
    leaves = {"a": torch.ones(4), "b": torch.full((3,), 2.0)}
    start = {k: torch.zeros_like(v) for k, v in leaves.items()}
    same = ([1.0, 0.5, 0.25], leaves, leaves)
    lim = {"loss_gap.step1": 0.0, "grad_gap.a": 0.0, "change_gap.b": 0.0}
    checks = invert.compare(same, same, start, lim)
    assert checks.correct and set(checks.numbers()) == {
        "step." + k for k in lim}
    halved = ([1.0, 0.5, 0.25], leaves, {"a": leaves["a"],
                                          "b": leaves["b"] / 2})
    assert not invert.compare(halved, same, start, lim).correct
