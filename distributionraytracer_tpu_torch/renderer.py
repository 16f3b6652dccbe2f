"""High-level renderer facade (counterpart of ``distributionraytracer_tpu.renderer``).

The scene's tensors move to ``device`` once (the card unless the caller asks
for ``"cpu"``).  A grid or BVH scene's acceleration structure is built on
the host once (:func:`build_accel`) and its tables moved there too.  Each
frame takes the route the JAX package takes on a TPU, chosen by the same
predicates once a frame into its plan (:meth:`Renderer._plan`), and
:meth:`Renderer.executed_backend` names it with the JAX package's label:

- accel NONE: ``fused-level`` (K3 per tree level), ``brute-kernel`` (K1/K2,
  scenes without lights) or ``plain`` (``kernels='off'``);
- ``binned-primary+grouped-packet`` / ``binned-primary+grid-packet``: the
  primary level by K9 over the frame's screen bins, every other level and
  every shadow query by K7 (on the grid emulation's tree, with the grid's
  gates, for grid scenes);
- ``binned+grouped-packet`` / ``binned+grid-packet``: as above, and the
  primary level's shadow query by K10 over the light bins; only while
  ``accel.cuda_binned.SHADOW_BINNING`` is set (off, as in the JAX
  package) and the bins build;
- ``grouped-packet`` / ``grid-packet``: K7 on every level (frames the bins
  do not tile, DOF, motion blur, planes);
- ``legacy-packet``: K8 (``packet_kernel='legacy'``, or trees the grouped
  packer refuses).  K8 takes every tree, also those the JAX package's K8
  refuses for its f32 encoding: the JAX package walks those by XLA
  (``bvh-xla``, ``grid-xla``), the port by K8 (``legacy-packet``,
  ``grid-packet``);
- ``cost-brute``: K1 and K2 with the accel's gates, for scenes of at most
  ``accel_cost_threshold`` objects without planes or moving spheres;
- ``grid-dda`` / ``bvh-threaded`` (``accel_backend='traversal'``, the JAX
  package's ``grid-xla`` / ``bvh-xla``): the plain torch 3D-DDA over the
  grid, or the stackless walk of the full threaded BVH, on any device.

``kernels='off'`` runs the plain versions on the same route.

Usage:
    r = Renderer(create_random_scene(0), device="cuda")
    img = r.render()                             # batch mode (Zone B)
    state = r.progressive_init()
    state = r.progressive_step(state, generator)  # Zone A frames
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from distributionraytracer_tpu_torch import native
from distributionraytracer_tpu_torch.accel import cuda_binned as CB
from distributionraytracer_tpu_torch.accel.bvh import (
    build_bvh, collapse_leaves, make_threaded_intersectors, protect_mask,
    thread_bvh,
)
from distributionraytracer_tpu_torch.accel.cuda_bvh import (
    PACKET_LEAF, pack_threaded, packet_intersectors,
)
from distributionraytracer_tpu_torch.accel.cuda_grid import (
    gated_intersectors, make_brute_grid_intersectors, pack_grid,
)
from distributionraytracer_tpu_torch.accel.cuda_packet import (
    GROUPED_LEAF, pack_grouped,
)
from distributionraytracer_tpu_torch.accel.grid import (
    build_grid, make_grid_intersectors,
)
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    SampleSet, SceneKey, TileGraphs, _block_perm, _FramePlan, _plan_frame,
    _sample_count, default_config, make_samples, progressive_init,
    progressive_samples, progressive_update, render_from_samples,
)
from distributionraytracer_tpu_torch.integrator.whitted import Intersectors
from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
from distributionraytracer_tpu_torch.ops.cuda_intersect import (
    ObjectColumns, object_columns,
)
from distributionraytracer_tpu_torch.ops.intersect import (
    any_hit_brute, closest_hit_brute,
)
from distributionraytracer_tpu_torch.scene.types import (
    ACCEL_BVH, ACCEL_GRID, ACCEL_NONE, OBJ_PLANE, OBJ_SPHERE, SceneData,
)
from distributionraytracer_tpu_torch.utils import spans

# the JAX brute kernel's table bound: cost-brute takes no larger scene
BRUTE_MAX_OBJECTS = 1024
BRUTE_MAX_UNROLL, BRUTE_LOOP_MIN = 128, 16


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def _brute_supported(scene: SceneData) -> bool:
    """The JAX brute kernel's applicability (pallas_intersect.py:282-292):
    1 to 1024 objects, and at most 128 objects in same-type runs shorter
    than 16.  Kept so that cost-brute routes the same scenes."""
    types = scene.static.obj_types
    if not 0 < len(types) <= BRUTE_MAX_OBJECTS:
        return False
    runs, prev = [], None
    for t in types:
        if runs and t == prev:
            runs[-1] += 1
        else:
            runs.append(1)
        prev = t
    return sum(n for n in runs if n < BRUTE_LOOP_MIN) <= BRUTE_MAX_UNROLL


def _use_cost_brute(scene: SceneData, cfg: RenderConfig) -> bool:
    """Small accel scenes take the brute kernels with the accel's gates,
    unless the accel's tested set is observable: infinite planes (their
    default boxes gate which rays test them) or moving spheres under motion
    blur (their hits escape the static boxes)."""
    st = scene.static
    if not cfg.accel_cost_threshold or st.n_objects > cfg.accel_cost_threshold:
        return False
    types = set(st.obj_types)
    if OBJ_PLANE in types or (cfg.motion_blur and OBJ_SPHERE in types):
        return False
    return _brute_supported(scene)


def _brute_bvh_intersectors(scene: SceneData, cfg: RenderConfig
                            ) -> Intersectors:
    """Cost-brute for BVH scenes: K1 closest (a BVH tests a superset-safe
    set, so no gate), K2 with the BVH compare ``t <= dist + EPSILON`` and no
    self-exclusion (bvh.cpp:376); the plain scans with ``kernels='off'``."""
    mb = cfg.motion_blur
    if cfg.kernels == "off":
        return Intersectors(
            lambda o, d, time, valid=None: closest_hit_brute(scene, o, d,
                                                             time, mb),
            lambda o, d, dist, ex, valid=None: any_hit_brute(
                scene, o, d, torch.zeros_like(dist), dist, None, mb,
                mode="bvh"))
    tb = CI.object_tables(scene)
    return Intersectors(
        lambda o, d, time, valid=None: CI.closest_hit(
            scene, o, d, time, mb, valid=valid, tables=tb),
        lambda o, d, dist, ex, valid=None: CI.any_hit(
            scene, o, d, dist, None, mb, "bvh", valid=valid, tables=tb))


class AccelBuild:
    """Host-built accel tables of one scene.  ``host`` is the full tree or
    grid (ThreadedBVH / GridArrays, NumPy); ``tabs`` the packet tables
    (PacketTables for BVH, CudaGrid for grid scenes); ``builder`` says
    whether ``native/`` or NumPy built them."""

    __slots__ = ("kind", "host", "tabs", "builder", "seconds")

    def __init__(self, kind, host=None, tabs=None, builder="numpy",
                 seconds=0.0):
        self.kind = kind
        self.host = host
        self.tabs = tabs
        self.builder = builder
        self.seconds = seconds


def build_accel(scene: SceneData, verbose: bool = False,
                motion_blur: bool = False, packet_kernel: str = "grouped",
                use_native: bool = True) -> AccelBuild:
    """Build a grid or BVH scene's tables on the host (grid.cpp:30-97,
    bvh.cpp:27-227).  ``motion_blur`` must match the render config: it
    decides which objects the leaf collapse protects and whether the grid
    emulation may keep sphere boxes tight.  ``packet_kernel`` selects the
    kernel the tables are packed for (K8 takes a tree K7's packer
    refuses).  ``seconds`` is the ``accel.build`` span's duration."""
    st = scene.static
    builder = native.builder() if use_native else "numpy"
    out = AccelBuild(st.accel, builder=builder)
    with spans.timed("accel.build") as sp:
        if st.accel == ACCEL_GRID:
            grid = build_grid(scene, use_native=use_native)
            out.host = grid
            out.tabs = pack_grid(scene, grid, motion_blur, packet_kernel,
                                 use_native=use_native)
            if verbose:
                n = grid.ncells
                print(f"GRID: total cells = {int(n[0] * n[1] * n[2])}, "
                      f"total objects = {st.n_objects}, ResX = {int(n[0])}, "
                      f"ResY = {int(n[1])}, ResZ = {int(n[2])}")
        elif st.accel == ACCEL_BVH:
            tb = thread_bvh(build_bvh(scene, use_native=use_native))
            prot = protect_mask(scene, motion_blur)
            tabs = None
            if packet_kernel == "grouped":
                tabs = pack_grouped(scene, collapse_leaves(
                    tb, GROUPED_LEAF, protect=prot))
            if tabs is None:
                tabs = pack_threaded(scene, collapse_leaves(
                    tb, PACKET_LEAF, protect=prot))
            out.host, out.tabs = tb, tabs
            if verbose:
                print(f"BVH: {tb.node_box.shape[0]} nodes over "
                      f"{st.n_objects} objects (threaded, {tabs.kind} packet "
                      "tables)")
    out.seconds = sp.seconds
    if verbose and st.accel != ACCEL_NONE:
        print(f"accel build: {out.seconds:.2f}s ({builder} builder)")
    return out


class _FrameTables(NamedTuple):
    """What a grid or BVH frame reads that no camera changes, kept by the
    Renderer across its frames (:meth:`Renderer._tables_for`)."""

    shape: Tuple[int, int, int]  # the frame's (H, W, S)
    tabs: object  # the accel tables they were made for
    key: SceneKey
    order: Tuple[torch.Tensor, torch.Tensor]  # ``_FramePlan.order``
    # ``cuda_binned._chain_grid`` of the order; None off the binned route
    chain_grid: Optional[tuple]
    # the route's walk: the traversal's, or the packet route's
    # (``packet_intersectors``); None on the cost-brute route
    walk: Optional[Intersectors]
    # the columns the packet walk and the binned wrapper read; None off
    # the packet route
    cols: Optional[ObjectColumns]


class Renderer:
    def __init__(self, scene: SceneData, cfg: Optional[RenderConfig] = None,
                 device="cuda", verbose: bool = False):
        self.cfg = cfg if cfg is not None else default_config(scene)
        self.device = resolve_device(device)
        self.scene = scene.to(self.device)
        self.accel = scene.static.accel
        self.accel_build = None
        self.tabs = None  # PacketTables (BVH) or CudaGrid (grid)
        self._graphs = TileGraphs()  # the fused-level route's, kept
        self._tables: Optional[_FrameTables] = None  # grid and BVH frames'
        if self.accel != ACCEL_NONE:
            ab = build_accel(scene, verbose=verbose,
                             motion_blur=self.cfg.motion_blur,
                             packet_kernel=self.cfg.packet_kernel)
            self.accel_build = ab
            self.tabs = ab.tabs.to(self.device)
        self._init_binning()

    # ---------------------------------------------------------- routing
    def _init_binning(self):
        """The camera-independent half of the binned route: the group
        boxes, and the light bins while ``cuda_binned.SHADOW_BINNING`` is
        set and they build (:func:`cuda_binned.shadow_binning_ok`).  Primary
        bins are built per camera and frame shape, lazily
        (:meth:`_bins_for`).  None with soft shadows, as in the JAX
        package: a training configuration, whose frames take the packet
        route."""
        self._gbox = None
        self._light_bins = None
        self._primary_cache = {}
        if (self.accel == ACCEL_NONE or self.cfg.soft_shadow > 0.0
                or self.cfg.accel_backend == "traversal"):
            return
        tabs = self.tabs.tabs if self.accel == ACCEL_GRID else self.tabs
        if tabs.kind != "grouped" or not CB.binned_supported(self.scene,
                                                             self.cfg):
            return
        self._gbox = CB.group_boxes(self.scene, tabs)
        if CB.SHADOW_BINNING:
            lb = CB.build_light_bins(self.scene, self._gbox)
            if CB.shadow_binning_ok(self.scene, lb):
                self._light_bins = lb.to(self.device)

    def _tables_for(self, H: int, W: int, S: int) -> _FrameTables:
        """The frame tables of a grid or BVH frame of this shape: those kept
        while the shape, the accel tables and the scene's ``SceneKey`` are
        the same (a new camera keeps them), else built anew, which counts
        ``tables.builds.frame_tables``: the pixel-block order of the rays,
        the route's walk (the traversal's, or the packet walk), and on the
        packet route its object columns and, where the binned route is
        eligible, the chain grid of the order."""
        sc, cfg = self.scene, self.cfg
        key, ft = SceneKey(sc, cfg), self._tables
        if (ft is not None and ft.shape == (H, W, S) and ft.tabs is self.tabs
                and ft.key == key):
            return ft
        spans.count("tables.builds.frame_tables")
        perm = _block_perm(H, W, S)
        gather = torch.as_tensor(perm, device=self.device).long()
        inverse = torch.empty_like(gather)
        inverse[gather] = torch.arange(gather.shape[0], device=self.device)
        chain_grid = walk = cols = None
        grid = self.accel == ACCEL_GRID
        if cfg.accel_backend == "traversal":
            host = self.accel_build.host
            walk = (make_grid_intersectors(sc, host, cfg.motion_blur) if grid
                    else make_threaded_intersectors(sc, host, cfg.motion_blur))
        elif not _use_cost_brute(sc, cfg):
            cols = object_columns(sc)
            walk = packet_intersectors(
                sc, self.tabs.tabs if grid else self.tabs, cfg.motion_blur,
                shadow_mode="grid" if grid else "bvh",
                plain=cfg.kernels == "off", cols=cols)
            if self._gbox is not None:
                chain_grid = CB._chain_grid(H, W, S, perm)
        self._tables = _FrameTables((H, W, S), self.tabs, key,
                                    (gather, inverse), chain_grid, walk, cols)
        return self._tables

    def _bins_for(self, H: int, W: int, S: int) -> Optional[CB.BinSet]:
        """The BinSet of this camera and frame shape, or None (the packet
        route takes the frame).  One camera's bins are cached."""
        if self._gbox is None:
            return None
        cg = self._tables_for(H, W, S).chain_grid
        if cg is None:
            return None
        with spans.span("render.bins"):
            sc = self.scene
            spans.host_read(sc.cam_eye, 3)
            key = (H, W, S) + tuple(tuple(a.cpu().numpy().tolist())
                                    for a in (sc.cam_eye, sc.cam_at,
                                              sc.cam_up))
            if key not in self._primary_cache:
                spans.count("bins.primary_builds")
                pb = CB.build_primary_bins(sc, self._gbox, H, W, S, cg)
                self._primary_cache.clear()
                self._primary_cache[key] = (None if pb is None
                                            else pb.to(self.device))
            pb = self._primary_cache[key]
        return None if pb is None else CB.BinSet(pb, self._light_bins)

    def _plan(self, samples: Optional[SampleSet] = None) -> _FramePlan:
        """The plan of a frame of ``samples`` (None: of the scene's own
        frame shape), from its shape and the scene, camera included, as it
        stands.  Grid and BVH frames take their route here (module
        docstring), in pixel-block order, from the frame tables this
        Renderer keeps (:meth:`_tables_for`); ``_plan_frame`` does the
        rest."""
        sc, cfg = self.scene, self.cfg
        if self.accel == ACCEL_NONE:
            return _plan_frame(sc, cfg, samples, graphs=self._graphs)
        mb, plain = cfg.motion_blur, cfg.kernels == "off"
        grid = self.accel == ACCEL_GRID
        shape = (samples.time.shape if samples is not None else
                 (sc.static.res_y, sc.static.res_x, _sample_count(sc, cfg)))
        ft = self._tables_for(*shape)
        tile, bins = cfg.tile_rays, None
        if cfg.accel_backend == "traversal":
            label = "grid-dda" if grid else "bvh-threaded"
            inter = ft.walk
        elif _use_cost_brute(sc, cfg):
            label = "cost-brute"
            inter = (make_brute_grid_intersectors(sc, self.tabs, mb, plain)
                     if grid else _brute_bvh_intersectors(sc, cfg))
        else:
            bins = self._bins_for(*shape)
            label = ("" if bins is None else "binned-primary+"
                     if bins.lights is None else "binned+")
            inter = ft.walk
            if bins is not None:
                inter = CB.leveled_binned_intersectors(
                    sc, self.tabs.tabs if grid else self.tabs, bins, inter,
                    mb, plain, shadow_mode="grid" if grid else "bvh",
                    cols=ft.cols)
                tile = 1 << 30  # the chain CSR addresses the whole frame
            if grid:
                label += "grid-packet"
                inter = gated_intersectors(self.tabs, inter)
            else:
                label += ("grouped-packet" if self.tabs.kind == "grouped"
                          else "legacy-packet")
        return _plan_frame(sc, cfg, samples, inter=inter)._replace(
            label=label, tile=tile, order=ft.order, bins=bins)

    def executed_backend(self) -> str:
        """The label of the route a render of the scene's own frame takes,
        from its plan (which builds what that frame builds), as the JAX
        package labels it (module docstring)."""
        return self._plan().label

    # ------------------------------------------------------------- batch
    def render_with_samples(self, samples: SampleSet, return_rays=False):
        with spans.span("render.frame"):
            samples = samples.to(self.device)
            return render_from_samples(self.scene, self.cfg, samples,
                                       return_rays=return_rays,
                                       plan=self._plan(samples))

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
