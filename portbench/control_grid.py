"""The control of the uniform-grid frame cell and the faults it is held
against, read at the cell's own size through the cell's own comparison
(``portbench.traffic.frames.compare``), as a run judges the program: each
reading puts an answer in the program's place and judges it by the
float32 grid reference (``portbench.reference.grid``).

    python3 -m portbench.control_grid --workload flake.turntable \\
        --seeds <n> [...]

prints one JSON line a seed and reading, with the numbers a run compares
beside their limits and ``correct`` as the run's ``harness.Checks``
decide it.  The readings, at frames 1 and 2 of the seed's orbit:

- ``control``: the reference computed in bfloat16, the nearest precision
  below the configuration's float32;
- ``stale_frame``: frame 1's image standing for frame 2 (the camera
  before);
- ``depth_3``: the tree cut one level short (``max_depth`` 3);
- ``dark_light``: light 0's shadow rays dropped, the light everywhere
  unshadowed.

A run of the benchmark never runs this.
"""

from __future__ import annotations

import argparse
import json

import torch

from portbench import harness, samples
from portbench.reference import scene as rscene
from portbench.traffic import frames
from portbench.traffic import grid_frames as tgrid

FRAMES = (1, 2)  # the frames read; the stale frame stands frame 1 for 2


def readings(ctx):
    """{reading: harness.Checks} of the cell's control and faults."""
    cfg, p, dev = ctx.config, ctx.params, ctx.device
    rs = rscene.ref_scene(cfg, dev)
    low = rscene.ref_scene(cfg, dev, torch.bfloat16)
    eye = tgrid.orbit(ctx, rs.eye.cpu().numpy(), rs.at.cpu().numpy())
    px = {i: frames.check_pixels(ctx, i) for i in FRAMES}

    def image(sc, i, at=None, **kw):
        at = i if at is None else at
        return tgrid.reference_frame(
            sc.with_eye(eye(at)), cfg,
            samples.frame_pixels(cfg, ctx.seed, at, dev), px[i], **kw)

    want = {i: image(rs, i) for i in FRAMES}

    def judge(scene=rs, **kw):
        return frames.compare([(image(scene, i, **kw), want[i])
                               for i in FRAMES], p["limits"])

    return {"control": judge(low),
            "stale_frame": frames.compare([(image(rs, 2, at=1), want[2])],
                                          p["limits"]),
            "depth_3": judge(max_depth=cfg["max_depth"] - 1),
            "dark_light": judge(dark=0)}


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
