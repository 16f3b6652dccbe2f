"""Render orchestration: sampling modes, tiling, progressive accumulation.

Counterpart of ``distributionraytracer_tpu.integrator.render``.  Mirrors
``renderScene`` (main.cpp:525-738):

- Zone B.1 (AA, spp > 0): n x n stratified jittered pixel samples + shuffled
  jittered light samples, optional thin-lens DOF, optional per-sample time.
- Zone B.2 (no AA, spp == 0): centre pixel sample; if light 0 is a quad,
  average over its gridRes regular light samples (main.cpp:674-703).
- Zone A (progressive): one jittered sample per pixel per call with a
  running-mean update ``lerp(old, new, 1/frame)`` (main.cpp:536-599).

PyTorch runs eagerly: the frame is traced in tiles by a Python loop, which
bounds the live ray-tree state, as the frame's plan (:func:`_plan_frame`)
says.  The renderer's grid and BVH routes plan their own tile, and their
rays are first grouped into square pixel blocks (:func:`_block_perm`, an
order the Renderer keeps across its frames), which the packet kernels and
the binned route rely on.  On the card's fused-level route, a
:class:`TileGraphs` replays each tile's whole ``trace_whitted`` as one
CUDA graph instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.whitted import (
    Intersectors, _tile_mode, level_route, levels_in_place, trace_whitted,
    trace_whitted_soft, tree_nodes,
)
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
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
    spans.count("tables.builds.block_perm")
    per = max(tile // max(S, 1), 1)
    bw = 1
    while bw * bw < per:
        bw *= 2
    bh = max(per // bw, 1)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    order = np.lexsort((xx.ravel() % bw, yy.ravel() % bh,
                        (xx // bw).ravel(), (yy // bh).ravel()))
    return (order[:, None] * S + np.arange(S)).ravel().astype(np.int32)


# The scene leaves a table kept across frames reads: all but the camera's,
# whose rays are a frame's inputs.
_TILE_LEAVES = tuple(n for n in SceneData._LEAF_NAMES
                    if not n.startswith("cam_"))


class SceneKey:
    """What a table kept across frames reads of a scene under a config:
    the config, the static metadata and every leaf but the camera's
    (``_TILE_LEAVES``), each the same tensor at the same ``_version``.
    Two keys are equal while all of these are; a new camera keeps the key,
    a new or edited leaf, static or config does not.  The one rule by
    which :class:`TileGraphs` and the Renderer's frame tables keep or
    rebuild what they hold."""

    __slots__ = ("cfg", "static", "leaves", "versions")

    def __init__(self, scene: SceneData, cfg: RenderConfig):
        self.cfg, self.static = cfg, scene.static
        self.leaves = tuple(getattr(scene, n) for n in _TILE_LEAVES)
        self.versions = tuple(x._version for x in self.leaves)

    def __eq__(self, other):
        return (isinstance(other, SceneKey) and self.cfg == other.cfg
                and self.static == other.static
                and all(a is b for a, b in zip(self.leaves, other.leaves))
                and self.versions == other.versions)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple  # the static (o, d, time, light_sample) it reads
    color: torch.Tensor  # the static (R, 3) colour it writes
    stats: dict  # its static ray counts, when it counts rays
    lanes: int  # tree lanes a replay traces (``whitted.lanes``)


class TileGraphs:
    """CUDA graphs of a tile's whole :func:`trace_whitted`, replayed for
    every tile of a frame whose plan's mode is ``graph``: a tile then
    costs four input copies, one replay and one output copy on the host.

    A ``Renderer`` owns one, kept across its frames; every other such
    frame makes its own.  It builds the scene's K3 tables
    (``CW.level_tables``) once, and keeps them and its graphs while the
    scene's :class:`SceneKey` holds; else it drops the graphs and builds
    the tables anew.  A new camera keeps both.  It holds at most
    two graphs for each "rays counted" (``return_rays``, or the recorder
    on): the full tile's, and one of the last, shorter tile, which a new
    short length replaces.  A capture first runs ``trace_whitted`` eagerly
    on a side stream, as a capture needs, then captures it; neither records
    a span.  The graphs share one memory pool: each replay's outputs are
    copied out before the next replay.
    """

    def __init__(self):
        self.tables: Optional[CW.LevelTables] = None
        self._held: Optional[SceneKey] = None  # the tables' key
        self._graphs = {}  # (full tile, rays counted) -> _Graph
        self._pool = None

    def prepare(self, scene: SceneData, cfg: RenderConfig):
        """Keep the tables and graphs for this frame, or drop the graphs
        and build the tables anew."""
        key = SceneKey(scene, cfg)
        if key == self._held:
            return
        self._graphs.clear()
        self.tables = CW.level_tables(scene)
        self._held = key

    def _capture(self, scene, cfg, rays, counting: bool) -> _Graph:
        inputs = tuple(x.clone() for x in rays)

        def run():
            return trace_whitted(scene, cfg, *inputs, count_rays=counting,
                                 tables=self.tables)

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        main, side = torch.cuda.current_stream(), torch.cuda.Stream()
        with spans.paused():
            side.wait_stream(main)
            with torch.cuda.stream(side):
                run()  # the eager warm-up a capture needs
            main.wait_stream(side)
            with torch.cuda.graph(graph, pool=self._pool):
                color, stats = run()
        CW.GRAPHS["captures"] += 1
        spans.count("whitted.graph_captures")
        return _Graph(graph, inputs, color, stats,
                      inputs[0].shape[0] * tree_nodes(scene, cfg))

    def trace(self, scene: SceneData, cfg: RenderConfig, rays, out,
              count_rays: bool, full: bool):
        """Trace one tile, ``rays`` = (o, d, time, light_sample), by its
        graph into ``out`` (the tile's (R, 3) rows of the frame's colours);
        ``full`` says whether it is a full tile.  Returns ``(out, stats)``,
        the stats as :func:`trace_whitted`'s with ``count_rays`` whenever
        the rays are counted.  Call :meth:`prepare` first, once a frame."""
        counting = count_rays or spans.enabled()
        key = (full, counting)
        g = self._graphs.get(key)
        if g is None or g.inputs[0].shape[0] != rays[0].shape[0]:
            self._graphs.pop(key, None)
            g = None  # a replaced graph's pool blocks serve the capture
            g = self._graphs[key] = self._capture(scene, cfg, rays, counting)
        for x, y in zip(g.inputs, rays):
            x.copy_(y)
        with spans.span("whitted.graph"):
            g.graph.replay()
        out.copy_(g.color)
        CW.GRAPHS["replays"] += 1
        spans.count("whitted.graph_replays")
        if not counting:
            return out, {}
        # copies: the next replay overwrites the graph's own counts
        stats = {k: v.clone() for k, v in g.stats.items()}
        spans.count("whitted.lanes", g.lanes)
        spans.count("whitted.levels_in_place", levels_in_place(scene, cfg))
        spans.count_device("whitted.lanes_live", stats["rays_traced"])
        spans.count_device("whitted.shadow_rays", stats["shadow_rays"])
        return out, stats


class _FramePlan(NamedTuple):
    """How a Whitted frame runs, decided once by :func:`_plan_frame`."""

    label: str  # the route's label (``Renderer.executed_backend``)
    mode: str  # how each tile runs (``whitted._tile_mode``)
    inter: Optional[Intersectors]  # the staged levels' intersectors
    tables: Optional[CW.LevelTables]  # the K3 tables of every tile
    tile: int  # primary samples a tile
    # the pixel-block order of the rays (:func:`_block_perm` on the
    # device, int64) and its inverse, or None: image order
    order: Optional[Tuple[torch.Tensor, torch.Tensor]]
    bins: Optional[object]  # the binned route's ``cuda_binned.BinSet``
    graphs: Optional[TileGraphs]  # the ``graph`` mode's replayer


def _plan_frame(scene: SceneData, cfg: RenderConfig,
                samples: Optional[SampleSet] = None,
                inter: Optional[Intersectors] = None, fused_grid=None,
                graphs: Optional[TileGraphs] = None) -> _FramePlan:
    """The plan of a frame of ``samples`` (None: of the scene's own frame):
    the level route as its label, the tiles' mode (from the samples'
    device and whether a gradient is recorded through the rays or a scene
    leaf) and the K3 tables the mode reads, built once for all the tiles,
    by ``graphs`` (else a :class:`TileGraphs` of the frame's own) in the
    ``graph`` mode.  The Renderer's grid and BVH routes pass their
    intersectors and replace the label, tile, block order and bins."""
    route = level_route(scene, cfg)
    read = () if samples is None else (
        samples.pixel, samples.light, *((samples.lens,) if cfg.dof else ()),
        *((samples.time,) if cfg.motion_blur else ()))
    needs_grad = torch.is_grad_enabled() and any(
        x.requires_grad
        for x in (*read, *(getattr(scene, n) for n in SceneData._LEAF_NAMES)))
    device = scene.device if samples is None else samples.time.device
    mode = _tile_mode(route, inter, fused_grid, cfg.soft_silhouette,
                      device.type, needs_grad, scene.static.has_skybox)
    tables = None
    if mode == "graph":
        graphs = TileGraphs() if graphs is None else graphs
        graphs.prepare(scene, cfg)
        tables = graphs.tables
    elif mode == "k3":
        tables = CW.level_tables(scene)
    return _FramePlan(route, mode, inter, tables, cfg.tile_rays, None, None,
                      graphs if mode == "graph" else None)


def render_from_samples(scene: SceneData, cfg: RenderConfig,
                        samples: SampleSet, row_offset=0,
                        inter: Optional[Intersectors] = None,
                        average: bool = True, return_rays: bool = False,
                        fused_grid=None, graphs: Optional[TileGraphs] = None,
                        plan: Optional[_FramePlan] = None):
    """Trace a SampleSet in tiles as ``plan`` (the Renderer's) says, or as
    :func:`_plan_frame` plans it from the arguments: ``inter`` stages every
    level on it, ``fused_grid`` (the grid's ``(bbox_min, bbox_max)``) runs
    them on K3 in grid mode, and ``graphs`` keeps the card's fused-level
    tile graphs across frames.  The image is the eager path's, bit for bit
    (the same kernels run in the same order on the same inputs).

    ``return_rays=True`` also returns the exact traced-ray count (tree
    nodes + shadow rays, the whitted.py counters) as an int64 tensor; the
    rays are counted only then (or while the recorder, ``utils.spans``,
    is on: see :func:`trace_whitted`).  The last tile is shorter rather
    than padded, so the count has no padding lanes.
    """
    if plan is None:
        plan = _plan_frame(scene, cfg, samples, inter, fused_grid, graphs)
    H, W, S = samples.time.shape
    o, d, t, ls = _rays_from_samples(scene, cfg, samples, row_offset)
    n, tile = o.shape[0], plan.tile
    if plan.order is not None:
        perm = plan.order[0]
        o, d, t, ls = o[perm], d[perm], t[perm], ls[perm]
    graphed = plan.mode == "graph"
    if graphed:
        frame = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    colors, counts = [], []
    for a in range(0, n, tile):
        b = min(a + tile, n)
        rays = (o[a:b], d[a:b], t[a:b], ls[a:b])
        with spans.span("render.tile"):
            if graphed:
                color, stats = plan.graphs.trace(
                    scene, cfg, rays, frame[a:b], return_rays, b - a == tile)
            elif plan.mode == "soft":
                color, stats = trace_whitted_soft(scene, cfg, *rays,
                                                  count_rays=return_rays)
            else:
                color, stats = trace_whitted(
                    scene, cfg, *rays, inter=plan.inter,
                    fused_grid=fused_grid, count_rays=return_rays,
                    tables=plan.tables)
        colors.append(color)
        if return_rays:
            counts += [stats["rays_traced"], stats["shadow_rays"]]
    colors = frame if graphed else torch.cat(colors)
    if plan.order is not None:
        colors = colors[plan.order[1]]
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
