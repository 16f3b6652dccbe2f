"""Intersectors and losses for inverse rendering.

Counterpart of the single-card parts of
``distributionraytracer_tpu.parallel.mesh``.  The CUDA kernels are
forward-only (their wrappers refuse tensors that require a gradient), so a
gradient step takes its intersectors from :func:`accel_intersectors` with
``differentiable=True``: the kernels pick each lane's winner under
``torch.no_grad()`` on a detached copy of the scene, and the winning hits
are recomputed in plain torch from the gradient-carrying scene
(:func:`integrator.whitted.differentiable_intersectors`)::

    scene = dataclasses.replace(scene, mat_cd=mat_cd)  # requires_grad
    inter = accel_intersectors(scene, cfg, None, differentiable=True)
    loss = l2_render_loss(scene, cfg, samples, target, inter=inter)
    loss.backward()

On CUDA tensors that is K1 and K2 (accel None) or K7/K8 (the packet tables
of a BVH scene); on CPU tensors their plain versions.  The sharded renders
and training steps are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from distributionraytracer_tpu_torch.accel.bvh import PacketTables
from distributionraytracer_tpu_torch.accel.cuda_bvh import packet_intersectors
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    SampleSet, render_from_samples,
)
from distributionraytracer_tpu_torch.integrator.whitted import (
    Intersectors, brute_intersectors, differentiable_intersectors,
)
from distributionraytracer_tpu_torch.scene.types import SceneData


def detached(scene: SceneData) -> SceneData:
    """``scene`` with every leaf detached from the autograd graph: the
    tables built from it never trip the kernels' gradient guard."""
    return SceneData(**{n: getattr(scene, n).detach()
                        for n in SceneData._LEAF_NAMES}, static=scene.static)


def accel_intersectors(scene: SceneData, cfg: RenderConfig, accel,
                       differentiable: bool = False
                       ) -> Optional[Intersectors]:
    """Intersectors for ``accel``: None (brute force) or the
    :class:`PacketTables` of a BVH scene (K7 on grouped tables, K8 on
    threaded ones).

    Without ``differentiable``, brute force returns None (the render's own
    route) and packet tables their packet intersectors.  With it, the
    forward-only base (``brute_intersectors``: K1/K2 on CUDA tensors, the
    plain scans on CPU ones or with ``kernels='off'``; or the packet walks)
    is built from detached tables and wrapped by
    :func:`differentiable_intersectors`.  Grid DDA and stack-BVH tables
    (the JAX package's XLA traversals) raise NotImplementedError.
    """
    if accel is not None and not isinstance(accel, PacketTables):
        raise NotImplementedError(
            f"accel_intersectors: {type(accel).__name__} tables (the grid "
            "DDA and stack-BVH traversals) are not ported yet (ROADMAP "
            "queue 1, Slice C2); pass the BVH scene's PacketTables")
    mb = cfg.motion_blur
    if accel is None:
        if not differentiable:
            return None
        base = brute_intersectors(detached(scene), cfg)
    else:
        tabs = PacketTables(accel.kind, accel.nodes.detach(),
                            accel.objs.detach())
        sc = detached(scene) if differentiable else scene
        base = packet_intersectors(sc, tabs, mb, plain=cfg.kernels == "off")
        if not differentiable:
            return base
    return differentiable_intersectors(scene, cfg, base)


def l2_render_loss(scene: SceneData, cfg: RenderConfig, samples: SampleSet,
                   target: torch.Tensor, row_offset=0,
                   inter: Optional[Intersectors] = None) -> torch.Tensor:
    """Mean squared error of the render of ``samples`` against ``target``
    (H, W, 3)."""
    img = render_from_samples(scene, cfg, samples, row_offset=row_offset,
                              inter=inter)
    return torch.mean((img - target) ** 2)
