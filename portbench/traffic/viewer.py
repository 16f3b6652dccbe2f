"""One viewer user: the program's browser viewer (``viewer.make_server``
on 127.0.0.1, a free port) in the run's process, and a closed loop that
sends ``/frame?progressive=1`` requests back to back, as the upstream's
browser page's frame loop does.  Each request adds one jittered sample a
pixel to the accumulator and returns the PNG; it is timed from its send to
its last byte.  ``request_ms_p95`` is the 95th percentile of every request
completed in the window.

Every ``moves_every`` requests the camera moves to the next of the cell's
``camera_offsets_deg`` (alpha and beta from the scene's camera, all above
the ground), which resets the accumulator.  Every seed visits the same
positions, in an order the seed draws, so that the seed changes the
samples and the order but not the work.  Before the window the benchmark
sets the viewer's seed and frame counter, so frame ``i`` of the window
draws its samples from ``(seed << 32) + i``, the viewer's own rule.

After the window, CHECK_REQUESTS requests drawn from the seed (the one
with the most accumulated frames among them) are decoded and compared with
the reference's running mean of the same frames, as bytes.
"""

from __future__ import annotations

import http.client
import sys
import threading
import time

import numpy as np
import torch

from portbench import harness, samples, trace
from portbench.reference import png
from portbench.reference import scene as rscene
from portbench.reference import viewer as rview

WARM_REQUESTS = 3  # requests set-up sends, at another camera
CHECK_REQUESTS = 3  # requests the reference checks, drawn from the seed
SPAN_REQUESTS = 16  # requests a traced run times with spans
TRACE_REQUESTS = 8  # requests a traced run profiles


def _get(port, path):
    """(status, body, seconds from send to the last byte)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.perf_counter()
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, body, time.perf_counter() - t0
    finally:
        conn.close()


def compare(pairs, limits):
    """The Checks of (PNG body, reference accumulator) pairs: each body
    decoded and held, as bytes, against the accumulator converted to bytes
    and flipped to the PNG's top-row-first order; the worst pair's share
    of pixels with a byte off by more than 2, and its mean absolute
    difference over 255.  A body that is not a PNG reads NaN."""
    bad, mean_abs = [], []
    for body, mean in pairs:
        want = png.to_u8(mean)[::-1].astype(np.int32)
        try:
            diff = np.abs(png.decode(body).astype(np.int32) - want)
        except ValueError:
            bad.append(float("nan"))
            mean_abs.append(float("nan"))
            continue
        bad.append(float((diff.max(-1) > 2).mean()))
        mean_abs.append(float(diff.mean()) / 255.0)
    checks = harness.Checks()
    checks.add("view.bad_px", max(bad) if bad else None, limits["bad_px"])
    checks.add("view.mean_abs", max(mean_abs) if mean_abs else None,
               limits["mean_abs"])
    return checks


def summary(secs, every):
    """Standard-error lines on the window's requests: their median, 95th
    percentile and largest time, the median at each place in a camera's
    run of ``every`` requests, and the ten slowest with their places."""
    ms = [s * 1e3 for s in secs]
    if not ms:
        return []
    at = [harness.median(ms[j::every]) for j in range(min(every, len(ms)))]
    slow = sorted(range(len(ms)), key=lambda k: -ms[k])[:10]
    return [f"requests: {len(ms)}, median {harness.median(ms):.3f} ms, "
            f"p95 {harness.p95(ms):.3f} ms, max {max(ms):.3f} ms",
            "median ms by place in a camera's run: "
            + " ".join(f"{x:.3f}" for x in at),
            "slowest (request, place, ms): " + " ".join(
                f"{k},{k % every},{ms[k]:.3f}" for k in slow)]


def run(ctx):
    from distributionraytracer_tpu_torch import viewer
    from portbench import program

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    H, W = cfg["res_y"], cfg["res_x"]
    scene = program.scene(cfg)
    httpd = viewer.make_server(scene, program.render_config(cfg), port=0,
                               device=dev)
    state, port = httpd.state, httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    ctx.mark("scene and server")
    every = int(p["moves_every"])
    cams = samples.cameras(ctx.seed, scene.cam_eye.numpy(),
                           p["camera_offsets_deg"], every, 1 << 16)
    try:
        # warm up at another camera, so the window's first request resets
        for k in range(WARM_REQUESTS):
            a, b, r = cams[0]
            _get(port, f"/frame?alpha={a + 180}&beta={b}&r={r}"
                       "&progressive=1")
        vseed = harness.derive_seed(ctx.seed, 7) % (1 << 31)
        state.seed, state.frame_i = vseed, 0
        ctx.sync()
        ctx.mark("warm-up requests")
        setup = ctx.setup_s()
        if dev != "cpu":
            torch.cuda.reset_peak_memory_stats()
        bodies, secs, failed = [], [], 0

        def request(k):
            a, b, r = cams[k]
            status, body, s = _get(port, f"/frame?alpha={a}&beta={b}&r={r}"
                                         "&progressive=1")
            bodies.append(body if status == 200 else None)
            secs.append(s)

        n, window = harness.closed_loop(ctx.seconds, request)
        failed = sum(b is None for b in bodies)
        for line in summary(secs[:n], every):
            print(line, file=sys.stderr)
        peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
        obs = {"unit": "request", "unit_s": window / n, "spans": ctx.spans}
        prof = None
        if ctx.trace and dev != "cpu":
            frame = state.frame

            def timed_frame(*a, **kw):
                t0 = time.perf_counter()
                out = frame(*a, **kw)
                ctx.span("render", time.perf_counter() - t0)
                return out

            state.frame = timed_frame
            m = SPAN_REQUESTS
            for k in range(n, n + m):
                before = len(ctx.spans.get("render", []))
                request(k)
                if len(ctx.spans["render"]) == before + 1:
                    ctx.span("serve", secs[-1] - ctx.spans["render"][-1])
            state.frame = frame
            base = n + m
            prof = trace.profile(
                lambda j, c: [request(base + k) for k in range(j, j + c)],
                TRACE_REQUESTS)
            del bodies[n:], secs[n:]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    del httpd, state
    if dev != "cpu":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    rs = rscene.ref_scene(cfg, dev)
    g = harness.rng(ctx.seed, 9)
    done = [k for k in range(n) if bodies[k] is not None]
    pick = set(int(k) for k in g.choice(done, size=min(
        CHECK_REQUESTS, len(done)), replace=False))
    pick.add(max(pick, key=lambda k: (k % every, k)))
    checks = compare([(bodies[k], rview.accumulator(
        rs, cams[k], vseed, k - k % every, k, H, W, cfg["max_depth"]))
        for k in sorted(pick)], p["limits"])
    print(f"reference check: {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    e2e = {"request_ms_p95": (harness.p95(secs[:n]) * 1e3, "ms"),
           "setup_s": (setup, "s")}
    return harness.Outcome(attempted=n, failed=failed, end_to_end=e2e,
                           checks=checks, memory_peak_bytes=int(peak),
                           obs=obs, profile=prof)
