"""Offline frames of a uniform-grid scene: the closed loop of ``frames``
(back-to-back renders through ``Renderer.render_with_samples``, each
frame ending with its (H, W, 3) image on the host, the camera turning
``orbit_deg`` a frame from a start the seed draws), held against the
grid's own reference ray tree (``portbench.reference.grid``).
``frame_ms`` is the window over the frames completed.

Parameters (the cell's ``params``): ``orbit_deg``, ``check_pixels`` and
``limits``, as ``frames`` reads them.

Set-up prints the route the start camera's frame takes
(``Renderer.executed_backend``).  A traced run profiles TRACE_FRAMES
frames, runs the program's own spans and counters over two more
(``portbench.program_trace``), and has the reference trace the profiled
frames whole to count their live rays (``obs["grid_floor_s"]``:
``portbench.roofline.accel_bytes_s`` of the reference's rays and the
scene's object rows).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from portbench import harness, program_trace, roofline, samples, trace
from portbench.reference import grid as ref
from portbench.reference import scene as rscene
from portbench.traffic import frames

WARM = 1 << 20  # sample keys of the set-up frames, apart from the window's
WARM_FRAMES = 2  # frames set-up renders
CHECK_FRAMES = 2  # frames the reference re-renders
TRACE_FRAMES = 2  # frames a traced run profiles


def reference_frame(rs, cfg, pix, pick, max_depth=None, dark=None):
    """The grid reference's frame of pixel samples ``pix``, or its pixels
    ``pick`` (``frames.check_pixels``); ``max_depth`` and ``dark`` (a
    light whose shadows are dropped) give the control's faults."""
    depth = cfg["max_depth"] if max_depth is None else max_depth
    with torch.no_grad():
        if pick is None:
            return ref.render(rs, pix, depth, dark=dark)
        return ref.render_pixels(rs, pix, *pick, depth, dark=dark)


def orbit(ctx, eye0, at):
    """(start degrees, degrees a frame, eye of frame i) of the run."""
    step = float(ctx.params.get("orbit_deg", 0.0))
    turn = round(360.0 / step) if step else 1
    start = float(harness.rng(ctx.seed, 11).integers(turn)) * step
    return lambda i: samples.orbit_eye(eye0, at, start + step * i)


def run(ctx):
    from portbench import program

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    t0 = time.perf_counter()
    scene = program.scene(cfg)
    ctx.mark("scene")
    r = program.Renderer(scene, program.render_config(cfg), device=dev)
    ctx.span("accel_build", time.perf_counter() - t0)
    ctx.mark("renderer (accelerator)")
    eye = orbit(ctx, scene.cam_eye.numpy(), scene.cam_at.numpy())

    def pixels(i):
        return samples.frame_pixels(cfg, ctx.seed, i, dev)

    H, W, S = cfg["res_y"], cfg["res_x"], max(cfg["spp"], 1)
    half = torch.full((H, W, S, 2), 0.5, device=dev)
    zero2, zero1 = torch.zeros_like(half), torch.zeros((H, W, S), device=dev)

    def place(i):
        r.scene = dataclasses.replace(
            r.scene, cam_eye=torch.as_tensor(eye(i), device=r.device))

    def frame(i):
        place(i)
        ss = program.SampleSet(pixel=pixels(i), light=half, lens=zero2,
                               time=zero1)
        return r.render_with_samples(ss).cpu()

    place(0)
    print(f"route at the start camera: {r.executed_backend()}",
          file=sys.stderr)
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
        base = n + TRACE_FRAMES + 1  # past the profile's last frame
        obs["program"] = program_trace.stretch(lambda i: frame(base + i), 2,
                                               "frame")
    del r
    if dev != "cpu":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    rs = rscene.ref_scene(cfg, dev)
    pick = harness.rng(ctx.seed, 2).choice(
        n, size=min(CHECK_FRAMES, n), replace=False)
    pairs = []
    for i in sorted(int(i) for i in pick):
        px = frames.check_pixels(ctx, i)
        got = images[i].to(dev)
        pairs.append((got if px is None else got[px],
                      reference_frame(rs.with_eye(eye(i)), cfg, pixels(i),
                                      px)))
    checks = frames.compare(pairs, p["limits"])
    print(f"reference check: {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    if prof is not None:
        floor = 0.0
        for i in traced:
            counts = {}
            with torch.no_grad():
                ref.render(rs.with_eye(eye(i)), pixels(i), cfg["max_depth"],
                           counts=counts)
            floor += roofline.accel_bytes_s(counts, rs.n_obj)
        obs["grid_floor_s"] = floor
        rays = sum(c["rays"] + c["shadow_rays"] for c in counts.values())
        print(f"reference rays, last profiled frame: {rays}",
              file=sys.stderr)
    e2e = {"frame_ms": (secs / n * 1e3, "ms"),
           "setup_s": (setup, "s")}
    return harness.Outcome(attempted=n, failed=0, end_to_end=e2e,
                           checks=checks, memory_peak_bytes=int(peak),
                           obs=obs, profile=prof)
