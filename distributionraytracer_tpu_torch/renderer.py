"""High-level renderer facade (counterpart of ``distributionraytracer_tpu.renderer``).

Covers the accel-NONE branch: the scene's tensors move to ``device`` once
(the card unless the caller asks for ``"cpu"``), and every render runs the
Whitted/distribution tree there.

Usage:
    r = Renderer(create_random_scene(0), device="cuda")
    img = r.render()                             # batch mode (Zone B)
    state = r.progressive_init()
    state = r.progressive_step(state, generator)  # Zone A frames
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    SampleSet, default_config, make_samples, progressive_init,
    progressive_samples, progressive_update, render_from_samples,
)
from distributionraytracer_tpu_torch.integrator.whitted import level_route
from distributionraytracer_tpu_torch.scene.types import ACCEL_NONE, SceneData


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


class Renderer:
    def __init__(self, scene: SceneData, cfg: Optional[RenderConfig] = None,
                 device="cuda"):
        if scene.static.accel != ACCEL_NONE:
            raise NotImplementedError(
                "grid and BVH scenes are not ported yet (ROADMAP: Slice D, "
                "accel routing in the renderer)")
        self.cfg = cfg if cfg is not None else default_config(scene)
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)

    def executed_backend(self) -> str:
        """The route every tree level takes: ``fused-level`` (K3),
        ``brute-kernel`` (K1/K2) or ``plain``.  The same predicate routes
        ``trace_whitted``.  On CPU tensors each kernel wrapper runs its
        plain version."""
        return level_route(self.scene, self.cfg)

    # ------------------------------------------------------------- batch
    def render_with_samples(self, samples: SampleSet, return_rays=False):
        return render_from_samples(self.scene, self.cfg,
                                   samples.to(self.device),
                                   return_rays=return_rays)

    def render(self, generator: Optional[torch.Generator] = None,
               return_rays=False):
        """Full Zone-B render (main.cpp:602-737): returns (H, W, 3) f32.

        ``return_rays=True`` also returns the exact traced-ray count
        (tree nodes + shadow rays)."""
        samples = make_samples(self.scene, self.cfg, generator)
        return self.render_with_samples(samples, return_rays=return_rays)

    # ------------------------------------------------------ progressive
    def progressive_init(self):
        return progressive_init(self.scene)

    def progressive_step(self, state, generator: torch.Generator):
        """One Zone-A frame (main.cpp:536-599)."""
        samples = progressive_samples(self.scene, self.cfg, generator)
        return progressive_update(self.cfg, state,
                                  self.render_with_samples(samples))

    # ------------------------------------------------------- checkpoint
    def save_progressive(self, path: str, state):
        """Checkpoint the (mean, count) accumulator (main.cpp:574-586)."""
        mean, count = state
        np.savez(path, mean=mean.detach().cpu().numpy(),
                 count=count.detach().cpu().numpy())

    def load_progressive(self, path: str):
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return (torch.as_tensor(z["mean"], device=self.device),
                torch.as_tensor(z["count"], device=self.device))
