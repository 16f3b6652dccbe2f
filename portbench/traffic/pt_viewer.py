"""One user of the path tracer's progressive viewer (P3D_RT.html's frame
loop): the program's ``viewer.make_server`` on 127.0.0.1, a free port,
holding a ``PTViewerState`` of GLSL scene 0 in the run's process, and a
closed loop that sends ``/frame?progressive=1`` requests back to back.
Each request adds one sample a pixel (10 bounces with roulette), drawn
from the viewer's own per-frame generator, to the accumulator and
returns the PNG; it is timed from its send to its last byte.
``request_ms_p95`` is the 95th percentile of every request completed in
the window.

Every ``moves_every`` requests the orbit camera moves to the next of the
cell's ``camera_offsets_deg`` ((alpha, beta) from the cell's ``orbit``,
the viewer's defaults for scene 0), in an order the seed draws, which
resets the accumulator.  Before the window the benchmark sets the
viewer's frame counter, so request ``i`` of the window draws its numbers
from ``(seed << 32) + i + 1``, the viewer's own rule, with the viewer's
seed drawn from the run's.

Parameters (the cell's ``params``): ``moves_every``,
``camera_offsets_deg``, ``orbit`` (``alpha``, ``beta``, ``r``, ``at``,
``fovy``), ``tile_paths`` (the render configuration's ``pt_tile_rays``),
``check_pixels`` (pixels compared in each checked request) and
``limits``.

After the window, CHECK_REQUESTS requests drawn from the seed are
decoded and their ``check_pixels`` pixels compared, as bytes, with the
reference's running mean of the same frames
(``portbench.reference.pt_viewer``).  A traced
run profiles TRACE_REQUESTS requests, then runs the program's own spans
and counters over three stretches of them
(``portbench.program_trace``).
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from portbench import harness, program_trace, trace
from portbench.reference import png
from portbench.reference import pt_scene
from portbench.reference import pt_viewer as ref
from portbench.traffic import viewer as tviewer

WARM_REQUESTS = 3  # requests set-up sends, at another camera
CHECK_REQUESTS = 3  # requests the reference checks, drawn from the seed
TRACE_REQUESTS = 8  # requests a traced run profiles, and a program stretch


def cameras(seed, orbit, offsets, every, count):
    """(alpha, beta, r) of requests 0..count-1: the orbit's default moved
    by one of ``offsets`` every ``every`` requests, cycling through them
    in an order the seed draws (the rule of ``samples.cameras``)."""
    order = np.random.default_rng(harness.derive_seed(seed, 8)).permutation(
        len(offsets))
    out = []
    for k in range(count):
        da, db = offsets[order[(k // every) % len(offsets)]]
        out.append((round(orbit["alpha"] + da, 3),
                    round(orbit["beta"] + db, 3), round(orbit["r"], 3)))
    return out


def check_pixels(ctx, k):
    """(rows, columns), row 0 at the bottom, of the pixels compared in
    request ``k``, drawn from the seed and the request."""
    g = harness.rng(ctx.seed, 12, k)
    npx = int(ctx.params["check_pixels"])
    H, W = ctx.config["res_y"], ctx.config["res_x"]
    return (torch.as_tensor(g.integers(0, H, npx), device=ctx.device),
            torch.as_tensor(g.integers(0, W, npx), device=ctx.device))


def pixels_of(body, pick):
    """(n, 3) bytes of a PNG body at pixels ``pick`` (rows, columns; row 0
    at the bottom, the PNG's last), or None where the body is not a
    PNG."""
    try:
        img = png.decode(body)
    except (ValueError, TypeError):
        return None
    rows, cols = (x.cpu().numpy() for x in pick)
    return img[img.shape[0] - 1 - rows, cols]


def compare(pairs, limits):
    """The Checks of (bytes (n, 3) or None, reference accumulator (n, 3))
    pairs, as ``viewer.compare`` holds a whole image: the accumulator
    converted to bytes; the worst pair's share of pixels with a byte off
    by more than 2 (``view.bad_px``) and its mean absolute difference over
    255 (``view.mean_abs``).  Missing bytes (a body that is not a PNG)
    read NaN."""
    bad, mean_abs = [], []
    for got, mean in pairs:
        if got is None:
            bad.append(float("nan"))
            mean_abs.append(float("nan"))
            continue
        diff = np.abs(np.asarray(got, np.int32)
                      - png.to_u8(mean).astype(np.int32))
        bad.append(float((diff.max(-1) > 2).mean()))
        mean_abs.append(float(diff.mean()) / 255.0)
    checks = harness.Checks()
    checks.add("view.bad_px", max(bad) if bad else None, limits["bad_px"])
    checks.add("view.mean_abs", max(mean_abs) if mean_abs else None,
               limits["mean_abs"])
    return checks


def view_seed(seed):
    return harness.derive_seed(seed, 7) % (1 << 31)


def run(ctx):
    from distributionraytracer_tpu_torch import viewer
    from distributionraytracer_tpu_torch.config import RenderConfig

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    H, W = cfg["res_y"], cfg["res_x"]
    rcfg = RenderConfig(max_bounces=cfg["max_bounces"],
                        russian_roulette=cfg["russian_roulette"],
                        pt_tile_rays=int(p["tile_paths"]))
    vseed = view_seed(ctx.seed)
    state = viewer.PTViewerState(0, rcfg, res=(W, H), device=dev,
                                 seed=vseed)
    httpd = viewer.make_server(None, rcfg, port=0, state=state)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    ctx.mark("scene and server")
    every = int(p["moves_every"])
    cams = cameras(ctx.seed, p["orbit"], p["camera_offsets_deg"], every,
                   1 << 16)

    def path(cam):
        a, b, r = cam
        return f"/frame?alpha={a}&beta={b}&r={r}&progressive=1"

    try:
        # warm up at another camera, so the window's first request resets
        a, b, r = cams[0]
        for _ in range(WARM_REQUESTS):
            tviewer._get(port, path((a + 180, b, r)))
        state.frame_i = 0
        ctx.sync()
        ctx.mark("warm-up requests")
        setup = ctx.setup_s()
        if dev != "cpu":
            torch.cuda.reset_peak_memory_stats()
        bodies, secs = [], []

        def request(k):
            status, body, s = tviewer._get(port, path(cams[k]))
            bodies.append(body if status == 200 else None)
            secs.append(s)

        n, window = harness.closed_loop(ctx.seconds, request)
        failed = sum(b is None for b in bodies)
        for line in tviewer.summary(secs[:n], every):
            print(line, file=sys.stderr)
        peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
        obs = {"unit": "request", "unit_s": window / n, "spans": ctx.spans}
        prof = None
        if ctx.trace and dev != "cpu":
            prof = trace.profile(
                lambda j, c: [request(n + k) for k in range(j, j + c)],
                TRACE_REQUESTS)
            base = n + TRACE_REQUESTS + 1  # past the profile's last request
            obs["program"] = program_trace.stretch(
                lambda i: request(base + i), TRACE_REQUESTS, "request")
            del bodies[n:], secs[n:]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    del httpd, state
    if dev != "cpu":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    rs = pt_scene.ref_scene(cfg, dev)
    g = harness.rng(ctx.seed, 9)
    done = [k for k in range(n) if bodies[k] is not None]
    pick = set(int(k) for k in g.choice(done, size=min(
        CHECK_REQUESTS, len(done)), replace=False))
    pairs = []
    for k in sorted(pick):
        px = check_pixels(ctx, k)
        pairs.append((pixels_of(bodies[k], px), ref.accumulator(
            rs, cfg, p["orbit"], cams[k], vseed, k - k % every, k, px,
            int(p["tile_paths"]))))
    checks = compare(pairs, p["limits"])
    print(f"reference check: {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    e2e = {"request_ms_p95": (harness.p95(secs[:n]) * 1e3, "ms"),
           "setup_s": (setup, "s")}
    return harness.Outcome(attempted=n, failed=failed, end_to_end=e2e,
                           checks=checks, memory_peak_bytes=int(peak),
                           obs=obs, profile=prof)
