"""Pixel-row sharding over ``torch.distributed``, mirroring
``tests/test_parallel.py`` on the CPU with gloo.

- ``_pad_rows``; the workers' module imports no JAX.
- A world-size-1 group in this process: ``render_image_sharded`` equal to
  ``Renderer.render_with_samples`` for accel NONE, grid and BVH scenes;
  ``render --sharded`` writing the unsharded command's image.
- Two gloo processes (:func:`spawn`: ``tests/torch_dist_worker.py``,
  spawned, joined through a ``file://`` store under ``tmp_path``, each
  with its own time limit): the train step's losses and updated
  ``mat_cd`` against the JAX package's ``make_sharded_train_step`` on a
  2-device mesh (accel NONE, ``small_scene``, rel 1e-5).
  ``test_torch_parallel_spawn.py`` has the other two-process tests.
"""

import dataclasses
import multiprocessing
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.distributed as dist

from distributionraytracer_tpu.config import RenderConfig as JaxConfig
from distributionraytracer_tpu.integrator.render import (
    make_samples as jax_make_samples, render_image as jax_render_image,
)
from distributionraytracer_tpu.parallel.mesh import (
    _pad_rows as jax_pad_rows, make_device_mesh,
    make_sharded_train_step as jax_train_step,
)
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    SampleSet, make_samples,
)
from distributionraytracer_tpu_torch.parallel.mesh import (
    _pad_rows, init_file_group, make_row_mesh, render_image_sharded,
)
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene import SceneBuilder
from distributionraytracer_tpu_torch.scene.types import (
    ACCEL_BVH, ACCEL_GRID, ACCEL_NONE,
)

import torch_dist_worker
from test_whitted import small_scene
from torch_port_util import to_port, torch_samples
from torch_scenes import mesh_scene, prim_scene

torch.set_num_threads(1)

JOIN_SECONDS = 120  # each spawned process's own limit


def spawn(tmp_path, job, args, world=2):
    """Run ``job`` on ``world`` gloo processes; rank r's results."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / f"store-{job}")
    procs = [ctx.Process(target=torch_dist_worker.run,
                         args=(r, world, store, str(tmp_path), job, args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_SECONDS)
            assert not p.is_alive(), f"{job}: a worker passed its time limit"
            assert p.exitcode == 0, f"{job}: a worker exited {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [dict(np.load(tmp_path / f"{job}-{r}.npz")) for r in range(world)]


def mesh(accel, res=(16, 13)):
    return mesh_scene(SceneBuilder, n_tri=1000, accel=accel, res=res,
                      ground="box")


def test_worker_imports_without_jax():
    """The spawned workers' module and the package they run import no
    JAX (a spawned process starts from a fresh import)."""
    code = ("import sys, torch_dist_worker\n"
            "from distributionraytracer_tpu_torch.parallel import mesh\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'distributionraytracer_tpu.')))\n"
            "assert not bad, bad\n")
    tests = os.path.dirname(os.path.abspath(__file__))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                       [tests, os.path.dirname(tests)])))


def test_pad_rows():
    s = make_samples(to_port(small_scene()), RenderConfig(spp=2),
                     torch.Generator().manual_seed(0))
    H = s.time.shape[0]
    same, h = _pad_rows(s, 2 if H % 2 == 0 else 1)
    assert same is s and h == H
    p, h = _pad_rows(s, 4)
    assert h == H and p.time.shape[0] == H + (-H) % 4 > H
    for f in dataclasses.fields(SampleSet):
        a, b = getattr(s, f.name), getattr(p, f.name)
        assert torch.equal(b[:H], a) and not b[H:].any()
    # the JAX package pads the same way
    jp, jh = jax_pad_rows(jax_make_samples(small_scene().device_put(),
                                           JaxConfig(spp=2),
                                           jax.random.PRNGKey(0)), 4)
    assert jh == H and jp.time.shape == tuple(p.time.shape)


def test_world_size_one_in_process(tmp_path):
    """A world-size-1 gloo group in this process: the sharded render is
    the Renderer's, for accel NONE (the default route), and for grid and
    BVH scenes on their host tables (the Renderer's ``'traversal'`` route)
    and their packet tables (its kernel route, whose primary level the
    binned walk takes: the reference's image budget)."""
    from test_whitted import assert_images_close

    init_file_group("cpu", str(tmp_path / "store"))
    try:
        rows = make_row_mesh("cpu")
        assert rows == (0, 1, torch.device("cpu"))
        for accel in (ACCEL_NONE, ACCEL_GRID, ACCEL_BVH):
            sc = mesh(accel) if accel else prim_scene(SceneBuilder)
            cfg = RenderConfig(spp=1)
            samples = make_samples(sc, cfg, torch.Generator().manual_seed(1))
            r = Renderer(sc, cfg, device="cpu")
            ref = r.render_with_samples(samples)
            img = render_image_sharded(r.scene, cfg, rows, samples=samples,
                                       accel=r.tabs)
            assert img.shape == ref.shape and float(ref.std()) > 0.02
            if accel == ACCEL_NONE:
                assert torch.equal(img, ref)
                continue
            assert_images_close(img.numpy(), ref.numpy())
            tcfg = cfg.replace(accel_backend="traversal")
            ref = Renderer(sc, tcfg, device="cpu").render_with_samples(
                samples)
            img = render_image_sharded(r.scene, tcfg, rows, samples=samples,
                                       accel=r.accel_build.host)
            np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0,
                                       atol=1e-6)
    finally:
        dist.destroy_process_group()


def test_two_process_train_step_matches_jax(tmp_path):
    """``test_sharded_train_step_reduces_loss``'s setup (small_scene, spp
    1, the target at half the diffuse colours), two steps at lr 0.5 on
    ``mat_cd``: the port's two gloo processes against the JAX package's
    step on a 2-device mesh, the same SampleSet and target."""
    js = small_scene().device_put()
    jcfg = JaxConfig(spp=1)
    samples = jax_make_samples(js, jcfg, jax.random.PRNGKey(9))
    target = jax_render_image(dataclasses.replace(js, mat_cd=js.mat_cd * 0.5),
                              jcfg, samples=samples)
    samples_p, H = jax_pad_rows(samples, 2)
    target_p = jnp.concatenate(
        [target, jnp.zeros((samples_p.time.shape[0] - H,)
                           + target.shape[1:])], axis=0)
    step = jax_train_step(jcfg, make_device_mesh(2),
                          samples_p.time.shape[0] // 2, lr=0.5,
                          update_leaves=("mat_cd",))
    s, losses = js, []
    for _ in range(2):
        loss, s = step(s, samples_p, target_p)
        losses.append(float(loss))
    out = spawn(tmp_path, "train", dict(
        scene=to_port(small_scene()), cfg=RenderConfig(spp=1),
        samples=torch_samples(samples),
        target=torch.from_numpy(np.asarray(target)), lr=0.5, steps=2))
    for res in out:  # every rank took the same steps
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(res["mat_cd"], np.asarray(s.mat_cd),
                                   rtol=1e-5)
    assert losses[1] < losses[0]


def test_cli_render_sharded_world_size_one(tmp_path, capsys):
    """``render --sharded`` without a group makes a world-size-1 one (gloo
    on the CPU), writes the unsharded command's image, and leaves no group
    behind."""
    from distributionraytracer_tpu_torch import cli
    from distributionraytracer_tpu_torch.utils.image import read_png

    args = ["render", "random", "--res", "16", "12", "--spp", "1",
            "--device", "cpu"]
    cli.main(args + ["-o", str(tmp_path / "plain.png")])
    cli.main(args + ["--sharded", "-o", str(tmp_path / "sharded.png")])
    assert "sharded render over 1 process(es), backend gloo" in \
        capsys.readouterr().out
    assert not dist.is_initialized()
    np.testing.assert_array_equal(read_png(str(tmp_path / "sharded.png")),
                                  read_png(str(tmp_path / "plain.png")))
