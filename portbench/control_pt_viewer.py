"""The control of the path tracer's viewer cell and the faults it is held
against, read at the cell's own size through the cell's own comparison
(``portbench.traffic.pt_viewer.compare``), as a run judges the program:
each reading puts an accumulator in the program's place and judges it by
the float32 reference's (``portbench.reference.pt_viewer``).

    python3 -m portbench.control_pt_viewer --workload pt0.view \\
        --seeds <n> [...]

prints one JSON line a seed and reading, with the numbers a run compares
beside their limits and ``correct`` as the run's ``harness.Checks``
decide it.  The readings, at the first camera's last two requests
(``moves_every`` - 2 and - 1, each accumulated from the camera's first):

- ``control``: the reference computed in bfloat16, the nearest precision
  below the configuration's float32;
- ``stale_accumulator``: the request before's accumulator standing for
  this one's;
- ``one_bounce_fewer``: ``max_bounces`` less one;
- ``no_boost``: Russian roulette without the survivors' 1/p boost.

A run of the benchmark never runs this.
"""

from __future__ import annotations

import argparse
import json

import torch

from portbench import harness
from portbench.reference import png
from portbench.reference import pt_scene
from portbench.reference import pt_viewer as ref
from portbench.traffic import pt_viewer as tview


def readings(ctx):
    """{reading: harness.Checks} of the cell's control and faults."""
    cfg, p, dev = ctx.config, ctx.params, ctx.device
    rs = pt_scene.ref_scene(cfg, dev)
    low = pt_scene.ref_scene(cfg, dev, torch.bfloat16)
    every, tile = int(p["moves_every"]), int(p["tile_paths"])
    cams = tview.cameras(ctx.seed, p["orbit"], p["camera_offsets_deg"],
                         every, every)
    vseed = tview.view_seed(ctx.seed)
    ks = (every - 2, every - 1)
    px = {k: tview.check_pixels(ctx, k) for k in ks}

    def acc(k, scene=rs, last=None, **kw):
        return ref.accumulator(scene, cfg, p["orbit"], cams[k], vseed, 0,
                               k if last is None else last, px[k], tile,
                               **kw)

    want = {k: acc(k) for k in ks}

    def judge(**kw):
        return tview.compare([(png.to_u8(acc(k, **kw)), want[k])
                              for k in ks], p["limits"])

    k = ks[1]
    return {"control": judge(scene=low),
            "stale_accumulator": tview.compare(
                [(png.to_u8(acc(k, last=k - 1)), want[k])], p["limits"]),
            "one_bounce_fewer": judge(max_bounces=cfg["max_bounces"] - 1),
            "no_boost": judge(boost=False)}


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
