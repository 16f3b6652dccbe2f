"""Offline frames: a closed loop of back-to-back renders through
``Renderer.render_with_samples``, each frame ending with its (H, W, 3)
image on the host.  ``frame_ms`` is the window over the frames completed.

Parameters (the cell's ``params``):

- ``orbit_deg``: the camera turns this many degrees a frame about the
  vertical axis through its look-at point, from a start the seed draws
  among the turn's positions (0: the configuration's camera);
- ``check_pixels``: pixels compared in each of the CHECK_FRAMES frames
  the reference re-renders after the window (0: all of them), both drawn
  from the seed;
- ``limits``: the limit of each compared number.

With spp > 0 each frame takes fresh stratified pixel samples drawn from
the seed and the frame's index; with spp 0 every frame takes the pixel
centres.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from portbench import harness, roofline, samples, trace
from portbench.reference import scene as rscene
from portbench.reference import whitted as ref

WARM = 1 << 20  # sample keys of the set-up frames, apart from the window's
WARM_FRAMES = 2  # frames set-up renders
CHECK_FRAMES = 2  # frames the reference re-renders
TRACE_FRAMES = 2  # frames a traced run profiles


def check_pixels(ctx, i):
    """(rows, columns) of the pixels compared in frame ``i``, drawn from
    the seed and the frame, or None where the cell compares every pixel."""
    npx = int(ctx.params.get("check_pixels", 0))
    if not npx:
        return None
    g = harness.rng(ctx.seed, 3, i)
    dev = ctx.device
    return (torch.as_tensor(g.integers(0, ctx.config["res_y"], npx),
                            device=dev),
            torch.as_tensor(g.integers(0, ctx.config["res_x"], npx),
                            device=dev))


def compare(pairs, limits):
    """The Checks of (got, want) images or pixel rows: the worst pair's
    share of pixels with a channel off by more than 0.02, and its mean
    absolute difference."""
    bad, mean_abs = [], []
    for got, want in pairs:
        diff = (got.float() - want.float()).abs()
        bad.append(float((diff.amax(-1) > 0.02).float().mean()))
        mean_abs.append(float(diff.mean()))
    checks = harness.Checks()
    checks.add("frame.bad_px", max(bad) if bad else None, limits["bad_px"])
    checks.add("frame.mean_abs", max(mean_abs) if mean_abs else None,
               limits["mean_abs"])
    return checks


def reference_frame(rs, cfg, pix, pick):
    """The reference's frame of pixel samples ``pix``, or its pixels
    ``pick`` (``check_pixels``)."""
    with torch.no_grad():
        if pick is None:
            return ref.render(rs, pix, cfg["max_depth"])
        return ref.render_pixels(rs, pix, *pick, cfg["max_depth"])


def run(ctx):
    from portbench import program

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    H, W, S = cfg["res_y"], cfg["res_x"], max(cfg["spp"], 1)
    t0 = time.perf_counter()
    scene = program.scene(cfg)
    ctx.mark("scene")
    r = program.Renderer(scene, program.render_config(cfg), device=dev)
    ctx.span("accel_build", time.perf_counter() - t0)
    ctx.mark("renderer (accelerator)")
    eye0, at = scene.cam_eye.numpy(), scene.cam_at.numpy()
    orbit = float(p.get("orbit_deg", 0.0))
    turn = round(360.0 / orbit) if orbit else 1
    start = float(harness.rng(ctx.seed, 11).integers(turn)) * orbit
    half = torch.full((H, W, S, 2), 0.5, device=dev)
    zero2, zero1 = torch.zeros_like(half), torch.zeros((H, W, S), device=dev)

    def eye(i):
        return samples.orbit_eye(eye0, at, start + orbit * i)

    def pixels(i):
        return samples.frame_pixels(cfg, ctx.seed, i, dev)

    def frame(i):
        if orbit:
            r.scene = dataclasses.replace(
                r.scene, cam_eye=torch.as_tensor(eye(i), device=r.device))
        ss = program.SampleSet(pixel=pixels(i), light=half, lens=zero2,
                               time=zero1)
        return r.render_with_samples(ss).cpu()

    for k in range(WARM_FRAMES):
        frame(WARM + k)
    ctx.sync()
    ctx.mark("warm-up frames")
    setup = ctx.setup_s()
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    images = []
    n, secs = harness.closed_loop(ctx.seconds,
                                  lambda i: images.append(frame(i)))
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    obs = {"unit": "frame", "unit_s": secs / n, "spans": ctx.spans,
           "accel": cfg["accel"]}
    prof, traced = None, []
    if ctx.trace and dev != "cpu":
        traced = list(range(n, n + TRACE_FRAMES))
        prof = trace.profile(
            lambda j, k: [frame(n + i) for i in range(j, j + k)], len(traced))
    del r
    if dev != "cpu":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    rs = rscene.ref_scene(cfg, dev)
    pick = harness.rng(ctx.seed, 2).choice(
        n, size=min(CHECK_FRAMES, n), replace=False)
    pairs = []
    for i in sorted(int(i) for i in pick):
        rsi = rs.with_eye(eye(i)) if orbit else rs
        px = check_pixels(ctx, i)
        got = images[i].to(dev)
        pairs.append((got if px is None else got[px],
                      reference_frame(rsi, cfg, pixels(i), px)))
    checks = compare(pairs, p["limits"])
    print(f"reference check: {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    if prof is not None:
        k3, floor = 0.0, 0.0
        for i in traced:
            counts = {}
            rsi = rs.with_eye(eye(i)) if orbit else rs
            with torch.no_grad():
                ref.render(rsi, pixels(i), cfg["max_depth"], counts=counts)
            k3 += roofline.k3_bound_s(counts, cfg["max_depth"], rs.n_obj,
                                      rs.lights.shape[0])
            floor += roofline.accel_bytes_s(counts, rs.n_obj)
        obs.update(k3_bound_s=k3, accel_floor_s=floor)
    e2e = {"frame_ms": (secs / n * 1e3, "ms"),
           "setup_s": (setup, "s")}
    return harness.Outcome(attempted=n, failed=0, end_to_end=e2e,
                           checks=checks, memory_peak_bytes=int(peak),
                           obs=obs, profile=prof)
