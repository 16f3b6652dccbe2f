"""Worker processes of ``test_torch_parallel.py``: each joins a gloo group
through a ``file://`` store, runs one job on its rows and writes what rank
0 (or every rank) found into ``out``.  Imports no JAX, so that the spawned
processes stay light; the test builds every input and passes it in."""

import os

import numpy as np
import torch


def run(rank, world, store, out, job, args):
    """Process entry point (``multiprocessing`` spawn target)."""
    import torch.distributed as dist

    from distributionraytracer_tpu_torch.parallel.mesh import (
        init_file_group, make_row_mesh,
    )

    torch.set_num_threads(1)
    init_file_group("cpu", store, rank, world)
    try:
        result = JOBS[job](make_row_mesh("cpu"), **args)
        np.savez(os.path.join(out, f"{job}-{rank}.npz"), **result)
    finally:
        dist.destroy_process_group()


def render(mesh, scene, cfg, samples, accel):
    from distributionraytracer_tpu_torch.parallel.mesh import (
        render_image_sharded,
    )
    img = render_image_sharded(scene, cfg, mesh, samples=samples,
                               accel=accel)
    return {"img": img.numpy()}


def train(mesh, scene, cfg, samples, target, lr, steps, accel=None):
    """``steps`` SGD steps on ``mat_cd`` of the padded frame: each step's
    loss and the updated ``mat_cd``."""
    from distributionraytracer_tpu_torch.parallel.mesh import (
        _pad_rows, make_sharded_train_step,
    )
    samples, H = _pad_rows(samples, mesh.world)
    target = torch.cat([target, target.new_zeros(
        (samples.time.shape[0] - H,) + target.shape[1:])])
    rows_per = samples.time.shape[0] // mesh.world
    step = make_sharded_train_step(cfg, mesh, rows_per, lr=lr,
                                   update_leaves=("mat_cd",), accel=accel)
    losses = []
    for _ in range(steps):
        loss, scene = step(scene, samples, target)
        losses.append(float(loss))
    return {"losses": np.asarray(losses), "mat_cd": scene.mat_cd.numpy()}


JOBS = {"render": render, "train": train}
