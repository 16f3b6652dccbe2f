"""The control of each cell and the faults it is held against, read at the
cell's own size: the reference put in the program's place, computed in
bfloat16 (the nearest precision below the configuration's float32), and
judged by the float32 reference through the cell's own comparison
(``compare`` of its traffic kind), as a run judges the program.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed and reading: the numbers a run compares, each
beside its limit, and ``correct`` as the run's ``harness.Checks`` decide
it; it has to come out false for the control.  For the frame cells it also
reads a stale frame (the frame before, as a step that returns its state
unchanged would), and for ``invert`` a loss over half of the pixels (half
of the batch left out, the mean taken over the rest).  A run of the
benchmark never runs this.
"""

from __future__ import annotations

import argparse
import json

import torch

from portbench import harness, samples
from portbench.reference import invert as rinv
from portbench.reference import png
from portbench.reference import scene as rscene
from portbench.reference import viewer as rview
from portbench.traffic import frames as tframes
from portbench.traffic import invert as tinvert
from portbench.traffic import viewer as tviewer


def frames(ctx, low):
    """Checks of frames 1 and 2 of the cell rendered by ``low`` (the
    bfloat16 reference), and of frame 1's image standing for frame 2."""
    cfg, p, dev = ctx.config, ctx.params, ctx.device
    rs = rscene.ref_scene(cfg, dev)
    orbit = float(p.get("orbit_deg", 0.0))
    eye0 = rs.eye.cpu().numpy()
    at = rs.at.cpu().numpy()

    def image(sc, i, px):
        s = sc.with_eye(samples.orbit_eye(eye0, at, orbit * i)) if orbit \
            else sc
        return tframes.reference_frame(
            s, cfg, samples.frame_pixels(cfg, ctx.seed, i, dev), px)

    px = {i: tframes.check_pixels(ctx, i) for i in (1, 2)}
    want = {i: image(rs, i, px[i]) for i in (1, 2)}
    lows = [(image(low, i, px[i]), want[i]) for i in (1, 2)]
    # the stale frame: frame 1's image, at frame 2's compared pixels
    stale = image(rs, 1, px[2])
    return {"control": tframes.compare(lows, p["limits"]),
            "stale_frame": tframes.compare([(stale, want[2])], p["limits"])}


def invert(ctx, low):
    """Checks of three bfloat16 reference steps, and of three float32
    steps whose loss covers the top half of the rows only."""
    cfg, p, dev = ctx.config, ctx.params, ctx.device
    H, W, S = cfg["res_y"], cfg["res_x"], int(p["spp"])
    rs = rscene.ref_scene(cfg, dev)
    start, true = rinv.start_and_truth(ctx.seed, p, rs)
    target = tinvert.target_image(ctx, rs, true)
    pix = [samples.stratified(harness.derive_seed(ctx.seed, 3, i), H, W, S,
                              dev) for i in range(rinv.CHECKED)]
    want = rinv.adam_steps(rs, start, pix, target, cfg["max_depth"],
                           p["lr"])
    lstart = {k: v.to(torch.bfloat16) for k, v in start.items()}
    got_low = rinv.adam_steps(low, lstart, pix, target, cfg["max_depth"],
                              p["lr"])
    half = rinv.adam_steps(rs, start, pix, target, cfg["max_depth"],
                           p["lr"], rows=H // 2)
    return {"control": tinvert.compare(got_low, want, start, p["limits"]),
            "half_batch": tinvert.compare(half, want, start, p["limits"])}


def viewer(ctx, low):
    """Checks of the bfloat16 reference's accumulators of requests 7 and
    8 (the first camera's last two), encoded as the PNG bodies a request
    returns."""
    cfg, p, dev = ctx.config, ctx.params, ctx.device
    H, W = cfg["res_y"], cfg["res_x"]
    rs = rscene.ref_scene(cfg, dev)
    every = int(p["moves_every"])
    cams = samples.cameras(ctx.seed, rs.eye.cpu().numpy(),
                           p["camera_offsets_deg"], every, every)
    vseed = harness.derive_seed(ctx.seed, 7) % (1 << 31)
    pairs = []
    for k in (every - 2, every - 1):
        want = rview.accumulator(rs, cams[k], vseed, 0, k, H, W,
                                 cfg["max_depth"])
        got = rview.accumulator(low, cams[k], vseed, 0, k, H, W,
                                cfg["max_depth"])
        pairs.append((png.encode(png.to_u8(got)[::-1]), want))
    return {"control": tviewer.compare(pairs, p["limits"])}


KINDS = {"frames": frames, "invert": invert, "viewer": viewer}


def readings(ctx):
    """{reading: harness.Checks} of the cell's control and faults."""
    low = rscene.ref_scene(ctx.config, ctx.device, torch.bfloat16)
    return KINDS[ctx.workload["kind"]](ctx, low)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        ctx = harness.Context(args.workload, seed, 0, 0)
        for reading, checks in readings(ctx).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": reading,
                              "checks": checks.as_dict(),
                              "correct": checks.correct}), flush=True)


if __name__ == "__main__":
    main()
