"""Inverse-rendering steps: Adam fits every material's diffuse colour
(``mat_cd``) and the sphere centres of the configuration's scene to a
target image, each step on fresh pixel samples over the whole frame.

A step is the program's render of the samples through
``parallel.mesh.accel_intersectors(scene, cfg, None, differentiable=True)``
(the closest- and any-hit kernels under no_grad, the winners' hits
recomputed in torch), the mean squared error, ``backward()`` and Adam's
update; it ends with the loss on the host.  ``step_ms`` is the window over
the steps completed.

Set-up builds the step (leaves and optimiser), drives its first three
steps through the window's own call, each on its own samples, and records
their losses, the first gradient as Adam's state holds it after one step,
and the leaves after three; the window then goes on with the same object.
After the window the reference repeats the three steps from the same
start, samples and target, and the run compares losses, gradient norms and
change norms (``reference.invert``).

Parameters: ``spp`` (samples a pixel a step), ``lr``, ``perturb_cd`` and
``perturb_center`` (the start: the true colours moved by a uniform draw of
that half-width and clamped to [0, 1], the small spheres' centres by a
normal draw of that deviation), ``target_spp``, and ``limits``: a limit
for each reading of ``reference.invert.leaf_gaps`` that is compared, by
its name.

The target is an input both sides get, like a photograph the user fits
to; the seconds the reference takes to render it at set-up are left out
of ``setup_s``.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from portbench import harness, samples, trace
from portbench.reference import invert as rinv
from portbench.reference import scene as rscene
from portbench.reference import whitted as ref


SPAN_STEPS = 4  # steps a traced run times with spans
TRACE_STEPS = 2  # steps a traced run profiles


def compare(got, want, start, limits):
    """The Checks of two (losses, first gradients, leaves after) triples:
    each reading of ``reference.invert.leaf_gaps`` that ``limits`` names,
    beside its limit."""
    readings = rinv.leaf_gaps(got, want, start)
    checks = harness.Checks()
    for name, lim in limits.items():
        checks.add("step." + name, readings.get(name), lim)
    return checks


def target_image(ctx, rs, true):
    """The target: the reference's render of the true leaves on samples
    drawn from the seed."""
    cfg, p = ctx.config, ctx.params
    with torch.no_grad():
        tpix = samples.stratified(harness.derive_seed(ctx.seed, 4),
                                  cfg["res_y"], cfg["res_x"],
                                  int(p["target_spp"]), ctx.device)
        return ref.render(rinv.with_leaves(rs, true), tpix,
                          cfg["max_depth"]).float()


def run(ctx):
    from distributionraytracer_tpu_torch.parallel.mesh import (
        accel_intersectors, l2_render_loss,
    )
    from portbench import program

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    H, W, S = cfg["res_y"], cfg["res_x"], int(p["spp"])
    rcfg = program.render_config(cfg, spp=S)
    scene = program.scene(cfg).to(dev)
    ctx.mark("scene")
    t_ref = time.perf_counter()
    rs = rscene.ref_scene(cfg, dev)
    start, true = rinv.start_and_truth(ctx.seed, ctx.params, rs)
    target = target_image(ctx, rs, true)
    ctx.sync()
    ctx.exclude(time.perf_counter() - t_ref)
    ctx.mark("target (reference, left out)")

    def pixels(i):
        return samples.stratified(harness.derive_seed(ctx.seed, 3, i), H, W,
                                  S, dev)

    leaves = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=p["lr"])
    half = torch.full((H, W, S, 2), 0.5, device=dev)
    zero2, zero1 = torch.zeros_like(half), torch.zeros((H, W, S), device=dev)

    def step(i, spans=False):
        sc = dataclasses.replace(scene, **leaves)
        inter = accel_intersectors(sc, rcfg, None, differentiable=True)
        ss = program.SampleSet(pixel=pixels(i), light=half, lens=zero2,
                               time=zero1)
        t0 = time.perf_counter()
        loss = l2_render_loss(sc, rcfg, ss, target, inter=inter)
        opt.zero_grad(set_to_none=True)
        if spans:
            ctx.sync()
            t1 = time.perf_counter()
            ctx.span("forward", t1 - t0)
        loss.backward()
        if spans:
            ctx.sync()
            ctx.span("backward", time.perf_counter() - t1)
        opt.step()
        return float(loss.detach())

    names = list(leaves)
    losses = []
    for i in range(rinv.CHECKED):
        losses.append(step(i))
        if i == 0:
            # Adam's first moment after one step is (1 - beta1) * gradient
            st = [opt.state.get(leaves[k], {}).get("exp_avg") for k in names]
            first = {k: None if s is None
                     else s.detach() / (1 - rinv.BETAS[0])
                     for k, s in zip(names, st)}
    change = {k: (leaves[k].detach() - start[k]).clone() for k in names}
    ctx.sync()
    ctx.mark("first steps")
    setup = ctx.setup_s()
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    n, secs = harness.closed_loop(ctx.seconds,
                                  lambda i: step(rinv.CHECKED + i))
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    obs = {"unit": "step", "unit_s": secs / n, "spans": ctx.spans}
    prof = None
    if ctx.trace and dev != "cpu":
        base = rinv.CHECKED + n
        for i in range(SPAN_STEPS):
            step(base + i, spans=True)
        base += SPAN_STEPS
        prof = trace.profile(
            lambda j, k: [step(base + i) for i in range(j, j + k)],
            TRACE_STEPS)
    del opt, leaves
    if dev != "cpu":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = rinv.adam_steps(rs, start, [pixels(i) for i in range(rinv.CHECKED)],
                           target, cfg["max_depth"], p["lr"])
    got = (losses, first, {k: start[k] + change[k] for k in names})
    print(f"reference check: {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    for k, v in rinv.leaf_gaps(got, want, start).items():
        print(f"reading {k}: {v!r}", file=sys.stderr)
    checks = compare(got, want, start, p["limits"])
    e2e = {"step_ms": (secs / n * 1e3, "ms"),
           "setup_s": (setup, "s")}
    return harness.Outcome(attempted=n, failed=0, end_to_end=e2e,
                           checks=checks, memory_peak_bytes=int(peak),
                           obs=obs, profile=prof)
