"""Render configuration (counterpart of ``distributionraytracer_tpu.config``).

The reference drives these knobs from compile-time flags and the P3F scene
file (main.cpp:29-39, scene.cpp:489-693).  Here they live in one frozen
dataclass: the knobs of the Whitted/distribution path (accel NONE, grid
and BVH, and which of their routes runs) and of the GLSL path tracer, and
the two gradient estimators' relaxation widths.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static knobs of a render.

    - ``max_depth``:   ``#define MAX_DEPTH 4`` (main.cpp:34).
    - ``spp``:         samples per pixel; ``0`` selects the no-AA branch
                       (main.cpp:674-703), ``>0`` stratified-jitter AA.
    - ``dof``:         thin-lens lens sampling (main.cpp:655-660).
    - ``motion_blur``: per-sample time jitter + moving sphere centers.
    - ``static_prune``: drop statically-dead ray-tree subtrees (no T==1
                       material => no refraction subtree; no Ks>0 material
                       => no reflection subtree).  Bit identical.
    - ``shadow_mode``: 'reference' keeps the accel-NONE quirk of comparing
                       occluders against a normalized direction (length
                       1.0, main.cpp:411-440); 'correct' uses the true
                       light distance.
    - ``max_samples``: progressive-mode cap, ``MAX_SAMPLES`` (main.cpp:39).
    - ``tile_rays``:   primary pixel-samples per tile.  Bounds the live
                       per-level state (the full tree of a whole 800x600
                       spp16 frame would need over 10 GB).
    - ``kernels``:     'auto' runs the CUDA kernels on CUDA tensors and the
                       plain torch versions on CPU tensors: one fused level
                       kernel per tree level where the scene has lights,
                       the closest/any-hit kernels with the staged shading
                       where it has none, the packet and binned kernels of
                       grid and BVH scenes, and the looped path-tracer
                       kernel, one launch per ``pt_trace`` call; 'off'
                       forces the plain staged path of accel-NONE scenes,
                       and the plain versions on the same route for grid
                       and BVH scenes.
    - ``packet_kernel``: the packet kernel of grid and BVH scenes: 'grouped'
                       (K7, over 8-object groups; the binned route needs
                       its tables) or 'legacy' (K8, the threaded tables; also
                       taken where the grouped packer refuses a tree).
                       The renderer traces these scenes in tiles of
                       ``tile_rays`` primary samples, the binned route in
                       one tile of the whole frame.
    - ``accel_backend``: the route of grid and BVH scenes, ``'auto' |
                       'traversal'`` for the JAX package's ``'pallas' |
                       'xla'``: 'auto' takes the packet and binned
                       kernels on CUDA tensors and their plain versions on
                       CPU ones (the routes listed in ``renderer.py``);
                       'traversal' takes the plain torch traversals on any
                       device, the 3D-DDA over the grid
                       (``accel.grid.make_grid_intersectors``) and the
                       stackless walk of the full threaded BVH
                       (``accel.bvh.make_threaded_intersectors``).  One
                       divergence, by design: the JAX package's 'auto'
                       takes its XLA traversals on the CPU, the port's the
                       kernels' plain versions, whose winners are the same.
    - ``accel_cost_threshold``: grid/BVH scenes with at most this many
                       objects (and no plane, no moving sphere) take the
                       brute kernels with the accel's gates ('cost-brute';
                       not under 'traversal'); 0 disables it.
    - ``soft_shadow``: 0 keeps the reference's hard boolean shadow gate
                       (main.cpp:383-451); > 0 replaces it with a
                       sigmoid-relaxed visibility of that width (world
                       units), so that expected pixel gradients at shadow
                       edges match finite differences
                       (:func:`ops.intersect.soft_visibility`).  Opt-in,
                       training-time only: the image softens within ~tau
                       of shadow boundaries, and every tree level takes
                       the staged route (K3 has no soft shadows).
    - ``soft_silhouette``: 0 keeps hard primary silhouettes; > 0 blends
                       each pixel with its "winner removed" counterfactual
                       by the winner's smooth coverage of that width
                       (world units, :func:`integrator.whitted.
                       trace_whitted_soft`), so that expected gradients at
                       hit-vs-miss edges match finite differences.
                       Training-time opt-in, ~2x a forward, plain torch on
                       the renderer's brute route only.
    - ``max_bounces``: path-tracer ``MAX_BOUNCES`` (P3D_RT.glsl:581).
    - ``russian_roulette``: path termination on the max throughput channel
                       with 1/p boost (P3D_RT.glsl:651-656).
    - ``pt_tile_rays``: path-tracer paths per tile (0 = no tiling); bounds
                       the per-bounce state and a tile's generator draws.
                       On the card, paths with injected uniforms go to the
                       looped K6 in one call (``pathtracer.trace_tiles``).
    """

    max_depth: int = 4
    spp: int = 0
    static_prune: bool = True
    kernels: str = "auto"  # 'auto' | 'off'
    packet_kernel: str = "grouped"  # 'grouped' | 'legacy'
    accel_backend: str = "auto"  # 'auto' | 'traversal'
    accel_cost_threshold: int = 1024
    dof: bool = False
    motion_blur: bool = False
    max_samples: int = 10000
    shadow_mode: str = "reference"  # 'reference' | 'correct'
    soft_shadow: float = 0.0
    soft_silhouette: float = 0.0
    tile_rays: int = 65536
    max_bounces: int = 10
    russian_roulette: bool = True
    pt_tile_rays: int = 131072

    def __post_init__(self):
        if self.shadow_mode not in ("reference", "correct"):
            raise ValueError(f"bad shadow_mode: {self.shadow_mode}")
        if self.kernels not in ("auto", "off"):
            raise ValueError(f"bad kernels mode: {self.kernels}")
        if self.packet_kernel not in ("grouped", "legacy"):
            raise ValueError(f"bad packet_kernel: {self.packet_kernel}")
        if self.accel_backend not in ("auto", "traversal"):
            raise ValueError(f"bad accel_backend: {self.accel_backend}")
        for name in ("soft_shadow", "soft_silhouette"):
            if not getattr(self, name) >= 0.0:
                raise ValueError(f"bad {name}: {getattr(self, name)} "
                                 "(a width, >= 0)")
        if self.tile_rays <= 0:
            raise ValueError(f"bad tile_rays: {self.tile_rays}")
        if self.pt_tile_rays < 0:
            raise ValueError(f"bad pt_tile_rays: {self.pt_tile_rays}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
