"""Render orchestration: sampling modes, tiling, progressive accumulation.

Counterpart of ``distributionraytracer_tpu.integrator.render``.  Mirrors
``renderScene`` (main.cpp:525-738):

- Zone B.1 (AA, spp > 0): n x n stratified jittered pixel samples + shuffled
  jittered light samples, optional thin-lens DOF, optional per-sample time.
- Zone B.2 (no AA, spp == 0): centre pixel sample; if light 0 is a quad,
  average over its gridRes regular light samples (main.cpp:674-703).
- Zone A (progressive): one jittered sample per pixel per call with a
  running-mean update ``lerp(old, new, 1/frame)`` (main.cpp:536-599).

PyTorch runs eagerly: the frame is traced in tiles of ``cfg.tile_rays``
primary samples by a Python loop, which bounds the live ray-tree state.  The
renderer's grid and BVH routes pass their own tile (``accel_tile``), and
their rays are first grouped into square pixel blocks (:func:`_block_perm`),
which the packet kernels and the binned route rely on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.whitted import (
    Intersectors, trace_whitted, trace_whitted_soft,
)
from distributionraytracer_tpu_torch.ops import sampling
from distributionraytracer_tpu_torch.ops.camera import (
    primary_rays, thin_lens_rays,
)
from distributionraytracer_tpu_torch.scene.types import (
    SceneData, derive_camera,
)
from distributionraytracer_tpu_torch.utils import spans


@dataclasses.dataclass
class SampleSet:
    """Explicit per-pixel-sample random numbers.

    Shapes: ``pixel (H,W,S,2)`` jitter in [0,1)^2 (already stratified for AA
    mode), ``light (H,W,S,2)`` in [0,1)^2, ``lens (H,W,S,2)`` unit-disk
    samples (scaled by aperture/2 internally), ``time (H,W,S)`` in [0,1).
    """

    pixel: torch.Tensor
    light: torch.Tensor
    lens: torch.Tensor
    time: torch.Tensor

    def to(self, device) -> "SampleSet":
        return SampleSet(*(getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)))

    def rows(self, start: int, stop: int) -> "SampleSet":
        """The horizontal slab of pixel rows ``start:stop``."""
        return SampleSet(*(getattr(self, f.name)[start:stop]
                           for f in dataclasses.fields(self)))


def default_config(scene: SceneData, **overrides) -> RenderConfig:
    """AA iff spp != 0; DOF iff aperture != 0 and AA (main.cpp:1004-1017)."""
    st = scene.static
    cfg = RenderConfig(spp=st.spp, dof=(st.aperture_ratio != 0.0
                                        and st.spp > 0))
    return cfg.replace(**overrides) if overrides else cfg


def _sample_count(scene: SceneData, cfg: RenderConfig) -> int:
    """Samples per pixel actually traced (S)."""
    st = scene.static
    if cfg.spp > 0:
        return cfg.spp
    if st.n_lights and st.light_quad[0]:
        return int(st.light_grid[0])  # regular light grid (main.cpp:684)
    return 1


def _generator(scene: SceneData, generator: Optional[torch.Generator]):
    if generator is None:
        generator = torch.Generator(device=scene.device).manual_seed(0)
    return generator


def make_samples(scene: SceneData, cfg: RenderConfig,
                 generator: Optional[torch.Generator] = None,
                 rows: Optional[int] = None) -> SampleSet:
    """Draw a SampleSet on the scene's device (draws run on the
    generator's device; the default generator is seeded with 0)."""
    st = scene.static
    g = _generator(scene, generator)
    dev = scene.device
    H = st.res_y if rows is None else rows
    W = st.res_x
    f32 = dict(dtype=torch.float32, device=dev)
    if cfg.spp > 0:
        S = cfg.spp
        pixel = sampling.stratified_jitter(g, S, (H, W)).to(dev)
        light = sampling.light_jitter_shuffled(g, S, (H, W)).to(dev)
    else:
        S = _sample_count(scene, cfg)
        pixel = torch.full((H, W, S, 2), 0.5, **f32)
        if st.n_lights and st.light_quad[0]:
            grid = torch.as_tensor(sampling.regular_grid(S), device=dev)
            light = grid.expand(H, W, S, 2).clone()
        else:
            light = torch.full((H, W, S, 2), 0.5, **f32)
    lens = (sampling.unit_disk(g, (H, W, S)).to(dev) if cfg.dof
            else torch.zeros((H, W, S, 2), **f32))
    time = (sampling.uniform(g, (H, W, S)).to(dev) if cfg.motion_blur
            else torch.zeros((H, W, S), **f32))
    return SampleSet(pixel=pixel, light=light, lens=lens, time=time)


def _rays_from_samples(scene: SceneData, cfg: RenderConfig,
                       samples: SampleSet, row_offset=0):
    """Build the flat primary-ray batch from a SampleSet.

    ``row_offset`` shifts the pixel-grid y coordinates, for rendering a
    horizontal slab of the image.
    """
    H, W, S = samples.time.shape
    dev = samples.time.device
    cam = derive_camera(scene)
    spans.count("tables.builds.pixel_grid")
    xy = np.stack(np.meshgrid(np.arange(W, dtype=np.float32),
                              np.arange(H, dtype=np.float32),
                              indexing="xy"), axis=-1)  # (H,W,2) = (x,y)
    xy = torch.as_tensor(xy, device=dev)
    xy = xy + torch.tensor([0.0, 1.0], device=dev) * row_offset
    pix = xy[:, :, None, :] + samples.pixel  # viewport coords
    time = (samples.time if cfg.motion_blur
            else torch.zeros_like(samples.time))
    if cfg.dof:
        lens = samples.lens * (cam.aperture / 2.0)
        o, d, t = thin_lens_rays(cam, lens, pix, time)
    else:
        o, d, t = primary_rays(cam, pix, time)
    n = H * W * S
    ls3 = torch.cat([samples.light, torch.zeros_like(samples.light[..., :1])],
                    dim=-1)
    return (o.reshape(n, 3), d.reshape(n, 3), t.reshape(n),
            ls3.reshape(n, 3))


def _block_perm(H: int, W: int, S: int, tile: int = 1024) -> np.ndarray:
    """Ray permutation grouping ~``tile`` rays into square pixel blocks.

    The flat (H, W, S) row-major order puts a traversal packet on a strip
    of pixels spanning the image; square blocks (32x32 pixels at S = 1)
    shrink the node union a packet walks, and give each 128-ray chain of
    the binned route a pixel rectangle.  The inverse gather restores image
    order, so output values are unchanged.
    """
    per = max(tile // max(S, 1), 1)
    bw = 1
    while bw * bw < per:
        bw *= 2
    bh = max(per // bw, 1)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    order = np.lexsort((xx.ravel() % bw, yy.ravel() % bh,
                        (xx // bw).ravel(), (yy // bh).ravel()))
    return (order[:, None] * S + np.arange(S)).ravel().astype(np.int32)


def render_from_samples(scene: SceneData, cfg: RenderConfig,
                        samples: SampleSet, row_offset=0,
                        inter: Optional[Intersectors] = None,
                        average: bool = True, return_rays: bool = False,
                        fused_grid=None, accel_tile: Optional[int] = None):
    """Trace a SampleSet in tiles of ``cfg.tile_rays`` primary samples.

    ``accel_tile`` (the renderer's grid and BVH routes) groups the rays
    into pixel blocks (:func:`_block_perm`) and traces them in tiles of
    that many.  ``fused_grid`` (the grid's ``(bbox_min, bbox_max)``) runs
    every level on K3 in grid mode.  With ``cfg.soft_silhouette > 0`` and
    no ``inter``, each tile goes through :func:`trace_whitted_soft`.

    ``return_rays=True`` also returns the exact traced-ray count (tree
    nodes + shadow rays, the whitted.py counters) as an int64 tensor; the
    rays are counted only then (or while the recorder, ``utils.spans``,
    is on: see :func:`trace_whitted`).  The last tile is shorter rather
    than padded, so the count has no padding lanes.
    """
    H, W, S = samples.time.shape
    o, d, t, ls = _rays_from_samples(scene, cfg, samples, row_offset)
    n = o.shape[0]
    perm = None
    tile = cfg.tile_rays
    if accel_tile is not None:
        spans.count("tables.builds.block_perm")
        perm = torch.as_tensor(_block_perm(H, W, S), device=o.device).long()
        o, d, t, ls = o[perm], d[perm], t[perm], ls[perm]
        tile = accel_tile
    colors, counts = [], []
    for a in range(0, n, tile):
        b = min(a + tile, n)
        with spans.span("render.tile"):
            if cfg.soft_silhouette > 0.0 and inter is None:
                color, stats = trace_whitted_soft(
                    scene, cfg, o[a:b], d[a:b], t[a:b], ls[a:b],
                    count_rays=return_rays)
            else:
                color, stats = trace_whitted(
                    scene, cfg, o[a:b], d[a:b], t[a:b], ls[a:b], inter=inter,
                    fused_grid=fused_grid, count_rays=return_rays)
        colors.append(color)
        if return_rays:
            counts += [stats["rays_traced"], stats["shadow_rays"]]
    colors = torch.cat(colors)
    if perm is not None:
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n, device=perm.device)
        colors = colors[inv]
    colors = colors.reshape(H, W, S, 3)
    img = colors.mean(dim=2) if average else colors
    return (img, torch.stack(counts).sum()) if return_rays else img


def render_image(scene: SceneData, cfg: Optional[RenderConfig] = None,
                 generator: Optional[torch.Generator] = None,
                 samples: Optional[SampleSet] = None, average: bool = True,
                 row_offset=0, inter: Optional[Intersectors] = None):
    """Render the full image; returns (H, W, 3) float32, y=0 at the bottom
    (viewport convention, main.cpp:604-605)."""
    if cfg is None:
        cfg = default_config(scene)
    if samples is None:
        samples = make_samples(scene, cfg, generator)
    return render_from_samples(scene, cfg, samples, row_offset, inter,
                               average)


# ----------------------------------------------------------------- progressive
def progressive_init(scene: SceneData):
    st = scene.static
    return (torch.zeros((st.res_y, st.res_x, 3), dtype=torch.float32,
                        device=scene.device),
            torch.zeros((), dtype=torch.float32, device=scene.device))


def progressive_samples(scene: SceneData, cfg: RenderConfig,
                        generator: torch.Generator) -> SampleSet:
    """One jittered sample per pixel (main.cpp:536-599)."""
    st = scene.static
    H, W, dev = st.res_y, st.res_x, scene.device
    u = lambda shape: sampling.uniform(generator, shape).to(dev)
    return SampleSet(
        pixel=u((H, W, 1, 2)), light=u((H, W, 1, 2)),
        lens=sampling.unit_disk(generator, (H, W, 1)).to(dev),
        time=(u((H, W, 1)) if cfg.motion_blur
              else torch.zeros((H, W, 1), dtype=torch.float32, device=dev)))


def progressive_update(cfg: RenderConfig, state, frame):
    """Running mean, capped at ``cfg.max_samples`` frames (main.cpp:537)."""
    mean, count = state
    new_count = torch.clamp(count + 1.0, max=float(cfg.max_samples))
    upd = count < float(cfg.max_samples)
    mean = torch.where(upd, mean + (frame - mean) / new_count, mean)
    return (mean, torch.where(upd, new_count, count))


def progressive_step(scene: SceneData, cfg: RenderConfig, state,
                     generator: torch.Generator):
    """One progressive frame: 1 jittered spp, running mean.

    The (mean, count) pair is a resumable state; checkpoint it to pause
    and resume a long accumulation.
    """
    frame = render_from_samples(scene, cfg,
                                progressive_samples(scene, cfg, generator))
    return progressive_update(cfg, state, frame)
