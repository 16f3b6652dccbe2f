"""The control of the path-traced frame cell and the faults it is held
against, read at the cell's own size through the cell's own comparison
(``portbench.traffic.pt_frames.compare``), as a run judges the program:
each reading puts an answer in the program's place and judges it by the
float32 reference.

    python3 -m portbench.control_pt --workload pt0.frame --seeds <n> [...]

prints one JSON line a seed and reading, with the numbers a run compares
beside their limits and ``correct`` as the run's ``harness.Checks``
decide it.  These have to come out false:

- ``control``: the reference computed in bfloat16, the nearest precision
  below the configuration's float32;
- ``stale_frame``: the frame before, standing for this one;
- ``no_boost``: Russian roulette without the survivors' 1/p boost.

``one_bounce_fewer`` (``max_bounces`` less one) is reported and need not
fail: the last bounce may carry too little to tell.  A run of the
benchmark never runs this.
"""

from __future__ import annotations

import argparse
import json

import torch

from portbench import harness
from portbench.reference import pt_scene
from portbench.traffic import frames
from portbench.traffic import pt_frames as tpt

FRAMES = (1, 2)  # the frames read; the stale frame stands frame 1 for 2


def readings(ctx):
    """{reading: harness.Checks} of the cell's control and faults."""
    cfg, p, dev = ctx.config, ctx.params, ctx.device
    rs = pt_scene.ref_scene(cfg, dev)
    low = pt_scene.ref_scene(cfg, dev, torch.bfloat16)
    drawn = {i: tpt.draw(cfg, ctx.seed, i, dev) for i in FRAMES}
    px = {i: frames.check_pixels(ctx, i) for i in FRAMES}
    want = {i: tpt.reference_pixels(rs, cfg, drawn[i], px[i])
            for i in FRAMES}

    def judge(scene=rs, **kw):
        return tpt.compare([(tpt.reference_pixels(scene, cfg, drawn[i],
                                                  px[i], **kw), want[i])
                            for i in FRAMES], p["limits"])

    stale = tpt.reference_pixels(rs, cfg, drawn[1], px[2])
    return {"control": judge(low), "no_boost": judge(boost=False),
            "one_bounce_fewer": judge(max_bounces=cfg["max_bounces"] - 1),
            "stale_frame": tpt.compare([(stale, want[2])], p["limits"])}


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
