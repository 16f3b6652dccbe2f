"""Reference inverse-rendering steps: the mean squared error of the
reference render against a target, its gradients by autograd in row
blocks, and Adam (Kingma and Ba, 2015, with PyTorch's defaults: betas 0.9
and 0.999, eps 1e-8, bias-corrected) written out."""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench.harness import derive_seed
from portbench.reference import whitted as ref

BETAS, EPS = (0.9, 0.999), 1e-8
CHECKED = 3  # steps the reference repeats


def with_leaves(sc, leaves):
    """A shallow copy of reference scene ``sc`` whose material colours and
    sphere centres are ``leaves["mat_cd"]`` and ``leaves["sph_center"]``."""
    out = object.__new__(type(sc))
    out.__dict__.update(sc.__dict__)
    out.cd, out.sph_c = leaves["mat_cd"], leaves["sph_center"]
    return out


def loss_and_grads(sc, leaves, pixel, target, max_depth, rows=None,
                   rows_per_block=60):
    """(loss, {name: gradient}) of the mean squared error over every pixel
    and channel of the first ``rows`` rows (all by default), accumulated
    over blocks of rows."""
    H, W = target.shape[:2]
    H = H if rows is None else rows
    xs = {k: v.detach().clone().requires_grad_(True)
          for k, v in leaves.items()}
    s = with_leaves(sc, xs)
    total = 0.0
    for a in range(0, H, rows_per_block):
        ys = torch.arange(a, min(a + rows_per_block, H),
                          device=target.device)
        img = ref.render(s, pixel, max_depth, rows=ys)
        part = ((img.float() - target[ys].to(img.dtype)) ** 2).sum() / (
            H * W * 3)
        if part.requires_grad:  # rows that hit nothing have no gradient
            part.backward()
        total += float(part.detach())
    return total, {k: torch.zeros_like(v) if v.grad is None
                   else v.grad.detach() for k, v in xs.items()}


def adam_steps(sc, leaves, pixels, target, max_depth, lr, rows=None):
    """Adam steps from ``leaves``, one a pixel sample set in ``pixels``,
    the loss over the first ``rows`` rows (all by default); returns
    (losses, the first step's gradients, the leaves after)."""
    x = {k: v.detach().clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in x.items()}
    v2 = {k: torch.zeros_like(v) for k, v in x.items()}
    losses, first = [], None
    for t, pixel in enumerate(pixels, 1):
        loss, g = loss_and_grads(sc, x, pixel, target, max_depth,
                                 rows)
        losses.append(loss)
        first = g if first is None else first
        for k in x:
            m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g[k]
            v2[k] = BETAS[1] * v2[k] + (1 - BETAS[1]) * g[k] * g[k]
            mh = m[k] / (1 - BETAS[0] ** t)
            vh = v2[k] / (1 - BETAS[1] ** t)
            x[k] = x[k] - lr * mh / (torch.sqrt(vh) + EPS)
    return losses, first, x


def leaf_norms(want):
    return {k: float(torch.linalg.vector_norm(w.double()))
            for k, w in want.items()}


def norm_gaps(got, want, med=None):
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf (``med``,
    by default over ``want``), whichever is larger.  Leaves whose
    reference norm is under a thousandth of the median leaf's are left out
    (their values move by round-off alone)."""
    norms = leaf_norms(want)
    med = statistics.median(norms.values()) if med is None else med
    gaps = []
    for k, w in norms.items():
        if w < 1e-3 * med:
            continue
        if got.get(k) is None:  # the program holds no such state
            return math.nan
        g = float(torch.linalg.vector_norm(got[k].double()))
        gaps.append(abs(g - w) / max(w, med))
    return max(gaps) if gaps else math.nan


def start_and_truth(seed, p, rs):
    """(start, truth): the leaves the steps start from, drawn from the
    run's seed, and the configuration's own, as {name: tensor}."""
    g = np.random.default_rng(derive_seed(seed, 5))
    true = {"mat_cd": rs.cd.clone(), "sph_center": rs.sph_c.clone()}
    cd0 = (rs.cd.cpu().numpy()
           + g.uniform(-1, 1, rs.cd.shape) * p["perturb_cd"])
    small = (rs.sph_r.cpu().numpy() < 100.0)[:, None]
    c0 = (rs.sph_c.cpu().numpy()
          + g.normal(0, 1, rs.sph_c.shape) * p["perturb_center"] * small)
    start = {"mat_cd": torch.as_tensor(cd0.clip(0, 1), dtype=torch.float32,
                                       device=rs.device),
             "sph_center": torch.as_tensor(c0, dtype=torch.float32,
                                           device=rs.device)}
    return start, true


def leaf_gaps(got, want, start):
    """Every reading of two (losses, first gradients, leaves after)
    triples: each step's relative loss gap, and each leaf's gap of
    first-gradient norms and of change norms
    (``reference.invert.norm_gaps``)."""
    (gl, gg, gx), (wl, wg, wx) = got, want
    out = {f"loss_gap.step{i + 1}": abs(a - b) / abs(b)
           for i, (a, b) in enumerate(zip(gl, wl))}
    for k in start:
        out[f"grad_gap.{k}"] = norm_gaps({k: gg[k]}, {k: wg[k]})
        out[f"change_gap.{k}"] = norm_gaps(
            {k: gx[k].float() - start[k]}, {k: wx[k].float() - start[k]})
    return out
