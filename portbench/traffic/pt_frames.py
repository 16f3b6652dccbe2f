"""Offline path-traced frames: a closed loop of back-to-back renders of the
GLSL path tracer's scene 0 through the program's ``render_pt``, as its
``pathtrace`` command renders them (the scene's tables moved to the
device, the configuration's camera, samples a pixel and bounces), each
frame ending with its (H, W, 3) linear image on the host.  ``frame_ms``
is the window over the frames completed.

Each frame's random numbers are drawn on the device from the seed and
the frame's index (:func:`draw`) and injected: the pixel jitter (H, W,
S, 2), the camera rays' times (H, W, S) and every bounce's uniforms over
the frame's H * W * S paths.

Parameters (the cell's ``params``):

- ``check_pixels``: pixels compared in each of the CHECK_FRAMES frames
  the reference re-traces after the window, both drawn from the seed;
- ``limits``: the limit of each compared number (:func:`compare`).

A traced run also profiles TRACE_FRAMES frames, runs the program's own
spans and counters over two more (``portbench.program_trace``), and has
the reference trace the profiled frames whole to count K6's work
(``portbench.roofline_pt``).
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import harness, program_trace, roofline_pt, trace
from portbench.reference import pt as ref
from portbench.reference import pt_scene
from portbench.traffic import frames

WARM = 1 << 20  # sample keys of the set-up frames, apart from the window's
WARM_FRAMES = 2  # frames set-up renders
CHECK_FRAMES = 2  # frames the reference re-traces
TRACE_FRAMES = 2  # frames a traced run profiles
SAMPLES = 21  # the seed key of a frame's random numbers


def draw(cfg, seed, i, device):
    """Frame ``i``'s (jitter, time, ``ref.Uniforms``), drawn in that order
    from one generator seeded by the run's seed and ``i``."""
    H, W, S, B = cfg["res_y"], cfg["res_x"], cfg["spp"], cfg["max_bounces"]
    R = H * W * S
    g = torch.Generator(device=device).manual_seed(
        harness.derive_seed(seed, SAMPLES, i))
    u = lambda *shape: torch.rand(shape, generator=g, device=device)
    jitter, times = u(H, W, S, 2), u(H, W, S)
    return jitter, times, ref.Uniforms(u(B, R, 2), u(B, R), u(B, R, 3),
                                       u(B, R, 3), u(B, R))


def camera(cfg):
    return ref.Camera(cfg["eye"], cfg["at"], cfg["fovy"], cfg["res_x"],
                      cfg["res_y"])


def reference_pixels(rs, cfg, drawn, pick, max_bounces=None, boost=True):
    """The reference's linear radiance at pixels ``pick`` (rows, columns)
    of the frame whose random numbers are ``drawn``, or of the whole
    frame where ``pick`` is None."""
    bounces = cfg["max_bounces"] if max_bounces is None else max_bounces
    with torch.no_grad():
        if pick is None:
            return ref.render(rs, camera(cfg), *drawn, bounces,
                              cfg["russian_roulette"], boost=boost)
        return ref.render_pixels(rs, camera(cfg), *pick, *drawn, bounces,
                                 cfg["russian_roulette"], boost=boost)


def compare(pairs, limits):
    """The Checks of (got, want) pixel rows: the worst pair's share of
    pixels with a channel off by more than 0.02 (``frame.bad_px``), its
    mean absolute difference (``frame.mean_abs``), and its
    |mean(got) - mean(want)| / mean(want) (``frame.mean_gap``), which a
    bias that moves every pixel a little shows and a few flipped lanes do
    not."""
    checks = frames.compare(pairs, limits)
    gaps = [float((got.float().mean() - want.float().mean()).abs()
                  / want.float().mean()) for got, want in pairs]
    checks.add("frame.mean_gap", max(gaps) if gaps else None,
               limits["mean_gap"])
    return checks


def run(ctx):
    from distributionraytracer_tpu_torch.config import RenderConfig
    from distributionraytracer_tpu_torch.integrator.pathtracer import (
        BounceUniforms, PTSamples, render_pt,
    )
    from distributionraytracer_tpu_torch.scene.pt_scenes import scene0

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    H, W, S = cfg["res_y"], cfg["res_x"], cfg["spp"]
    scene = scene0().to(dev)
    ctx.mark("scene")
    rcfg = RenderConfig(max_bounces=cfg["max_bounces"],
                        russian_roulette=cfg["russian_roulette"])

    def frame(i):
        jitter, times, uni = draw(cfg, ctx.seed, i, dev)
        return render_pt(scene, rcfg, W, H, eye=cfg["eye"], at=cfg["at"],
                         fovy=cfg["fovy"], spp=S,
                         samples=PTSamples(jitter, times,
                                           BounceUniforms(*uni))).cpu()

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
    obs = {"unit": "frame", "unit_s": secs / n, "spans": ctx.spans}
    prof, traced = None, []
    if ctx.trace and dev != "cpu":
        traced = list(range(n, n + TRACE_FRAMES))
        prof = trace.profile(
            lambda j, k: [frame(n + i) for i in range(j, j + k)], len(traced))
        base = n + TRACE_FRAMES + 1  # past the profile's last frame
        obs["program"] = program_trace.stretch(lambda i: frame(base + i), 2,
                                               "frame")
    del scene
    if dev != "cpu":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    rs = pt_scene.ref_scene(cfg, dev)
    pick = harness.rng(ctx.seed, 2).choice(
        n, size=min(CHECK_FRAMES, n), replace=False)
    pairs = []
    for i in sorted(int(i) for i in pick):
        px = frames.check_pixels(ctx, i)
        got = images[i].to(dev)
        pairs.append((got if px is None else got[px],
                      reference_pixels(rs, cfg, draw(cfg, ctx.seed, i, dev),
                                       px)))
    checks = compare(pairs, p["limits"])
    print(f"reference check: {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    if prof is not None:
        bound = 0.0
        for i in traced:
            counts = {}
            with torch.no_grad():
                ref.render(rs, camera(cfg), *draw(cfg, ctx.seed, i, dev),
                           cfg["max_bounces"], cfg["russian_roulette"],
                           counts=counts)
            bound += roofline_pt.k6_bound_s(counts, sum(rs.counts),
                                            rs.plight_pos.shape[0])
        obs["k6_bound_s"] = bound
    e2e = {"frame_ms": (secs / n * 1e3, "ms"),
           "setup_s": (setup, "s")}
    return harness.Outcome(attempted=n, failed=0, end_to_end=e2e,
                           checks=checks, memory_peak_bytes=int(peak),
                           obs=obs, profile=prof)
