#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit; exits non-zero without CUDA.
2. Builds the kernels from ``distributionraytracer_tpu_torch/csrc`` with
   nvcc (``ops/build.py``) and prints the build time and ptxas's register
   and spill report (K1's to K6's, the four K7/K8 walks', K9's and K10's
   registers, shared memory and spills on lines of their own).
3. Holds each Whitted kernel against its plain torch version on the card,
   on 65,536 random rays against a scene with all four primitive types, a
   quad light and a point light:
   - K1 closest hit: hit/object/material ids equal, t and normal within
     rtol 1e-4, atol 1e-4;
   - K2 any hit: occlusion equal, in all three modes (and 7c: on every
     lane of every launch of the staged and cost-brute frames);
   - K3 fused level: spawn on and off, motion blur on, valid lanes: flags
     equal, child origins within 1e-5 of their magnitude, every other float
     within atol 2e-4;
   each but for at most 0.01% of the lanes (the measure-zero edges).
4. Holds each path-tracer kernel against its plain version on 65,536 lanes
   of scene 0 (triangles, spheres, moving spheres at times in [0, 1)) and
   scene 3 (quad light, cubemap sky with synthetic faces):
   - K4 closest: hit and material equal, t within rtol 2e-4, normals beyond
     1e-3 on under 0.5% of the hits (and 7c: every lane of every launch of
     the staged frame's middle tile equal to ``hit_world``);
   - K5 any hit: occlusion equal;
   - K6 bounce, from camera rays and from the state after three bounces,
     on the same uniforms: alive flags equal, origins within 1e-5 of their
     magnitude, every other state row within atol 2e-3 + rtol 2e-3;
   each but for at most 0.01% of the lanes;
   - the looped K6 (``pt_trace``), four bounces from camera rays, against
     four plain bounces: colours (and scene 3's latched miss rows) within
     atol 2e-3 + rtol 2e-3 but for at most 0.01% of the lanes a bounce.
5. Renders the built-in random scene at 800x600, 16 spp, depth 4 in three
   runs, each with every launch counter set to 0 just before it and read
   just after it:
   - the Whitted main path, ``Renderer.render_with_samples`` (fused-level
     route): K3 only;
   - ``Renderer.render_with_samples`` on the same scene without its lights
     (brute-kernel route, the one a light-less scene takes): K1 only, as
     there are no shadow rays;
   - ``render_from_samples(..., inter=brute_intersectors(...))``, the
     staged kernel route with lights: K1 and K2.
   Rows 284:316 of each are held to a plain-torch render of the same rows
   of the same SampleSet (at most 0.5% of elements beyond 3e-3, max
   difference 0.05).  Then times FRAMES warm frames of the main path with
   torch.cuda.synchronize and prints their spread and rays/s.  The main
   path replays each tile as a CUDA graph, whose kernels no launcher call
   counts: its K3 launches a frame (590: 118 tiles of 5 levels) are the
   ``whitted_level_kernel`` activities in the device trace of one more
   warm frame under ``torch.profiler`` (the frame step 8 prints), and
   each counted run prints its graph replays beside its launches.
6. Path traces scene 0 at 800x600, 16 spp, 10 bounces through ``render_pt``
   in two counted runs: the path tracer's main path (the fused body): K6
   only, one looped launch a tile (every bounce, the tile's uniforms drawn
   from the generator up front); the staged body with
   ``kernel_queries``: K4 and K5 only.  Puts the camera rays of rows
   284:316 (409,600 paths, uniforms drawn once) through ``ray_color`` on
   the fused kernel, the staged kernels and plain torch, and holds both
   kernel routes to plain with the statistic of test_pallas_pt (under 5%
   of elements beyond 1e-3, |mean difference| under 5e-3).  Times FRAMES
   warm frames and prints Msamples/s and the peak device memory.
6b. Builds the host builders of ``native/drt_native.cpp`` (fails if the
   native builder is not the one that builds the tables) and renders the
   accelerated frame, ``tests/torch_scenes.py::mesh_scene`` (100,000
   triangles, a ground sphere and four spheres, 512x512, spp 0, depth 4),
   on five routes, each between a reset and a read of the launch counters:
   - the main path, ``Renderer.render_with_samples`` on the BVH scene
     (``binned-primary+grouped-packet``): K9 once, on the primary level,
     and K7 on every other level and every shadow query, nothing else;
   - the grid scene (``binned-primary+grid-packet``): K9 and K7;
   - ``packet_kernel='legacy'`` (``legacy-packet``): K8 only;
   - the 1,005-object scene, BVH and grid (``cost-brute``): K1 and K2;
   - ``render_from_samples(..., fused_grid=)`` on the small grid scene:
     K3 in grid mode only.
   Rows 240:272 of each are held to plain torch on the same SampleSet
   (``assert_images_close``'s budget), then five warm frames of the main
   path are timed (rays/s by the whitted.py counters, peak memory).
   K9, K7 and K8 (closest at level 1; shadow, both modes, at the primary
   level) are held to their plain versions on the main path's own inputs
   (ids and occlusion equal, t within 1e-5 relative; a lane that is not
   valid a miss); K9 and K7 (closest, and shadow in grid mode) also on
   the grid route's own inputs and emulation tree; K3 grid mode on a
   65,536-lane tile of the small grid scene (the K3 budgets).  K9's chain
   skew on both routes' batches, from its plain version's per-chain
   counts: groups streamed and slot tests (median, 90th percentile,
   maximum, the chain with the most and its share of the whole), beside
   the candidate lists' lengths; its bare launch held to its plain
   version too, and its work list to ``closest_work_plain``.
6c. The same frame with a finite ground (``mesh_scene(..., ground="box")``,
   whose point lights lie outside the scene box) and the light bins built
   (``cuda_binned.SHADOW_BINNING`` set while the renderers are made; the
   host seconds of ``build_light_bins`` printed), on three routes, each
   between a reset and a read of the launch counters:
   - ``binned+grouped-packet`` (BVH): K9 once, K10 once (the primary
     level's shadow query, 3 lights x 262,144 lanes), K7 on the rest;
   - ``binned+grid-packet`` (grid, K10 in grid shadow mode): the same;
   - the BVH scene with the switch off (``binned-primary+grouped-packet``):
     K9 and K7, no K10.
   Rows 240:272 of each are held to plain torch as in 6b.  K10 is held to
   its plain version in both shadow modes on each binned+ route's own
   primary shadow inputs (occlusion equal on every lane), its work list
   (the chains' records, rows and item starts) to ``shadow_work_plain``,
   and it prints E, the work items, the most entries an item streams (at
   most E) and its bare launch; it is compared with K7's any-hit on the
   same inputs (lanes differing printed, at most 0.2%).  Five warm frames
   of the binned+ BVH route and five of the switched-off route alternate:
   medians, rays/s and peak memory of each.
7. Times each kernel and its plain version at its main path's shapes (K1
   to K3: one 65,536-sample tile of the Whitted frame; K4 to K6: one
   131,072-path tile at bounce 0 of the path-traced frame; the looped K6:
   7b's tile, every bounce, its floor summed over the bounces' live
   paths from the states 7b records; K7 to K9 and
   K3's grid mode: the inputs of 6b; K10: the binned+ BVH route's primary
   shadow batch of 6c, beside K7's bare launch on it) with CUDA
   events: the bare launch on the streams the kernel reads (``ms``) and
   the wrapper with whatever packing it does (``wrapper_ms``).  Beside each, the least time the
   card could take for the same work (``bound_ms``): the larger of the
   bytes over 3.35 TB/s and the FP32 operations over 67 TFLOP/s, counted
   from these inputs (tests up to the first occluder where a fold stops
   there; dead lanes skipped; per-lane branches as the constants below
   say; for K7 to K9, the node and object tests their plain walks made;
   for K10, the smaller of its own stream's work and the plain packet
   walk's on the same lanes, since both give this occlusion).  A sphere
   test whose discriminant is negative counts its operations up to it.
   Then records every K7/K8 launch of one frame of the accelerated main
   path, the grid route and the legacy route, and times each: K7 at each
   launch of the main path (levels 1-4 closest, 0-4 shadow) beside its
   live share and the plain walk's node and object tests per live lane,
   held to the plain walk on every lane; the bare launches' sums over each
   frame; K8 on its row's inputs (the main path's level-1 closest and
   primary shadow launches).
7b. Times K3 at each level (0-4) of the Whitted frame's middle tile and K6
   at each bounce (0-9) of the PT frame's middle tile, on the inputs the
   frames give them (K6: the looped launch's recorded camera rays and
   uniforms, taken a bounce at a time through single-bounce launches),
   each beside its valid or live share, and holds each launch to its
   plain version.  The looped K6 on that tile must give the single-bounce
   launches' final colours bit for bit, and is held to ten plain bounces
   as in step 4; then its row (``pt_bounce_loop``) is timed.
7c. Records the inputs of every K1 and K2 launch of the Whitted staged route
   (``render_from_samples(..., inter=brute_intersectors(...))``) on its
   middle tile and of every K4 and K5 launch of the PT staged body
   (``render_pt(..., queries=kernel_queries(...))``) on its middle tile,
   and of every K1 and K2 launch of one cost-brute frame of each mode
   (BVH, grid): K1 and K2 at each level 0-4 with its lane count and valid
   share (K1 held to ``closest_hit_brute`` within the K1 budget and to its
   run fold ``closest_hit_runs`` on every lane), the cost-brute frames'
   bare-launch sums, K1's row at the cost-brute shape (a tile's 65,536
   primary rays against 1,005 objects), K4 at each
   bounce 0-9 with the share of lanes whose ray moved since the last
   bounce, K5 at each
   bounce 0-9 and point light with its lane count and the share of lanes
   live before the query (the lanes whose answer the staged body keeps),
   each launch timed bare and held to its plain version on every lane
   (lanes differing must be 0).  Then two warm frames of each staged
   route and one more under ``torch.profiler``: device-busy time, idle
   share, the frame sums of K1 and K2 (Whitted staged) and K4 and K5 (PT
   staged), and the copy kernels that K1's, K2's and K5's wrappers
   launch.
8. Profiles one more warm frame of each main path under ``torch.profiler``
   (the Whitted one is step 5's) and prints the device-busy time, the
   idle share and the top device kernels, K3's and the looped K6's summed
   time in their frames beside their single-launch and per-tile times, and K7's
   (accelerated frame) and K8's (one legacy-route frame) beside theirs;
   one frame of the binned+ and the switched-off box-ground routes, with
   K10's frame sum.
9. Gradients: three inverse-rendering steps on the Whitted frame's scene
   (a 32-row band of the 800x600 spp16 frame, rows 284:316, 409,600
   samples, which bounds the autograd graph every tile of a loss keeps
   alive until its backward).
   The target is the band's K3 render under no_grad; the start has every
   material colour 0.1 brighter; each step takes the L2 loss and its
   gradient in ``mat_cd`` through ``accel_intersectors(...,
   differentiable=True)``, between a reset and a read of the launch
   counters (K1 and K2 only, never K3), and a projected SGD step follows.
   Checks: the default route refuses a leaf that requires a gradient (the
   kernels' guard), every gradient is finite and not all zero, the loss
   after the third step is below the first.  Prints each step's seconds
   (forward + backward; the median after the first), its forward's rays/s,
   the peak device memory and K1's and K2's sums in one profiled step.
   Then holds the K1/K2 route to plain autodiff (``kernels='off'``) on
   rows 284:288 (51,200 samples): loss within rel 1e-4, the ``mat_cd`` and
   ``sph_center`` gradients within 1e-3 of their largest element.
   The grid half: the same three steps on the accelerated grid frame of
   5b (100,000 triangles, 512x512, spp 0, depth 4), its band of rows 0:32
   (16,384 samples; row offset 0, so that phase 10's world-size-1 step
   renders the same rows), through ``accel_intersectors(CudaGrid,
   differentiable=True)``: K7 in grid shadow mode under no_grad, never K3.
   Checks: the loss falls at every step; the K7 route against its plain
   walk (``kernels='off'``) on rows 0:4, loss within rel 1e-4 and the
   ``mat_cd`` and ``sph_center`` gradients within 1e-3 of their largest
   element.  Prints the step seconds (median of steps 1-3), K7's launches
   a step, one profiled step's busy ms, idle share and K7 sums, the peak
   memory.  Then one step through the DDA (``accel_intersectors(
   GridArrays)``, the ``accel_backend='traversal'`` route; no kernel
   launches), its seconds, and the share of the band's primary object ids
   where the DDA and the emulation differ (under 2%, the emulation's tie
   budget).
10. Row sharding at world size 1 on an NCCL group (made from a ``file://``
   store in a temporary directory; no fallback to gloo):
   ``render_image_sharded`` of the Whitted frame (K3 only, equal to
   ``Renderer.render_with_samples``: max difference 0; on its own
   ``TileGraphs``, a second frame's device trace holds the main path's 590
   K3 launches) and of the grid frame on its ``CudaGrid`` tables (K7
   only, equal to ``render_from_samples(inter=accel_intersectors(...))``,
   and within the slab budget of the Renderer's own K9 + K7 route over
   the whole frame); one ``make_sharded_train_step`` step on the grid
   band, whose loss must be phase 9's step 0 (rel 1e-6); an
   ``all_reduce``'s milliseconds.
11. The browser viewer (``viewer.py``), both states served by
   ``make_server(..., port=0)`` on a thread and fetched with ``urllib`` on
   127.0.0.1: the Whitted ``ViewerState`` of ``create_random_scene(0)``
   (800x600, spp 16 for the batch frame) and the ``PTViewerState`` of
   scene 0 (800x600, 10 bounces, 1 spp a frame).  Each: the page and
   ``/state``, 409 for a screenshot before any frame, 404 for an unknown
   route, a warm-up frame at another camera, five progressive
   ``/frame``s at the state's camera (``X-Samples`` 1 to 5), each between
   a reset and a read of the launch counters (K3 only, 8 tiles x 5
   levels; K6 only, one looped launch a tile, 4 tiles), a camera move
   (``X-Samples``
   1), a batch frame, ``/screenshot?path=`` read back by ``read_png`` as
   (600, 800, 3).  The Whitted accumulator after frame 5 must equal
   ``Renderer.progressive_step`` at the same eye on the same generators
   (difference 0), its first frame the same frame with
   ``kernels='off'``: at most 0.5% of elements beyond 3e-3 and at most
   ``LANE_BUDGET`` of the pixels (one sample a pixel: a lane that flips
   keeps its whole difference, which 16-spp slabs average); the PT
   accumulator must equal five ``render_pt`` calls on the same generators
   folded by the same rule (difference 0).  Prints each request's
   launches, the requests' median and spread and frames per second, the
   render alone (synchronised) and ``png_bytes`` alone.

Prints the kernels' JSON line, then the result line last.  Any failure
raises, so the exit code is non-zero and no result line is printed.
"""

import bisect
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
LANE_BUDGET = 1e-4  # share of lanes whose flags may flip (FMA contraction)
SLAB = (284, 316)  # pixel rows of the plain-torch comparison slab
FRAMES = 5  # timed warm frames of each main path
POINT_KEYS = ("refr_o", "refl_o")  # K3 outputs that are points in space
PT_FRAME = dict(scene=0, res=(800, 600), spp=16, bounces=10,
                eye=[6.0, 1.6, -6.0], at=[0.0, 0.5, 0.0])

# The card's peaks (NVIDIA's H100 SXM data sheet, at its 700 W limit).
MEM_BPS = 3.35e12
FP32_OPS = 67e12
# FP32 operations (add, sub, mul, div, sqrt, rsqrt, min, max, exp, pow, sin,
# cos, fmod, floor: one each; compares, selects, negations and abs not
# counted), counted line by line in the kernels' sources.  A lane counts
# the branch it takes where this run's data says which (hit or miss, winner
# type, material, facing, shadowed, survived); where it does not, the
# cheaper branch, so the bound stays a floor.
# Whitted (csrc/primitives.cuh, csrc/whitted_level.cu), by object type
# (sphere, triangle, plane, box): the tests (a sphere's under motion blur
# adds one), and the winner's normal once per hit, after the fold.  A
# sphere whose discriminant is negative (or NaN) returns before its root:
# it counts its operations up to the discriminant, W_SPHERE_MISS_OPS.  The
# sphere quadratic's a = d.d is the ray's, W_FOLD_OPS once per lane and
# fold that reaches a sphere.  Where a count comes from a walk's per-type
# test totals (K7-K10), which do not say which branch a sphere took nor
# which lanes tested one, spheres count the miss and no d.d.
W_TEST_OPS = (28, 46, 13, 25)
W_SPHERE_MISS_OPS = 20
W_FOLD_OPS = 5
W_WALK_OPS = (W_SPHERE_MISS_OPS,) + W_TEST_OPS[1:]
W_NORMAL_OPS = (18, 18, 0, 7)
W_LANE_OPS = 40  # K3 per lane: unit normal, point, facing, view, shadow origin
W_LIGHT_OPS = 40  # K3 per lane and light: direction, distance, half vector
W_QUAD_OPS = 12  # K3 per lane and quad light: the jittered light point
W_SHADE_OPS = 18  # K3 per light that lights a hit: its colour added
W_SPAWN_OPS = 97  # K3 per lane: both children's directions, Fresnel, origins
W_BEER_OPS = 9  # K3 per lane whose normal does not face the ray: Beer
W_REFR_OPS = 6  # K3 per refraction child: its weight
W_REFL_OPS = 3  # K3 per reflection child: its weight
# Path tracer (csrc/pt.cu): tests (triangle, sphere, moving sphere); each
# fold also takes d.d; the winner's normal and point once per hit (18 for a
# triangle or sphere; a moving sphere's 24 or 30 are counted as 18).  A
# sphere or moving sphere whose discriminant is negative (or NaN) counts
# its operations up to it (PT_MISS_TEST_OPS).
PT_TEST_OPS = (46, 28, 53)
PT_MISS_TEST_OPS = (46, 20, 45)
PT_FOLD_OPS = 5
PT_WINNER_OPS = 18
# K6 per lane: a miss under the gradient sky (a cubemap miss only stores);
# a hit: unit normal, point, view, both sphere samples, the reflection, the
# throughput of a path roulette kills; a striped or an emissive hit; the
# scatter by material type (diffuse, metal, dielectric, plastic; the
# cheaper branch of the last two); a path that survives roulette.
PT_MISS_OPS = 19
PT_HIT_OPS = 116
PT_STRIPE_OPS = 3
PT_EMIT_OPS = 6
PT_SCATTER_OPS = (12, 0, 37, 61)
PT_SURVIVE_OPS = 11
# K6 per light of a hit: a point light's direction, distance and facing
# test, then the shadow ray's setup if it faces it; a quad light's jittered
# point, direction and facing test; per light that lights the hit, the
# Blinn and GGX factors (a quad light's own GGX half vector adds 13) and
# the three channels by material type.
PT_POINT_OPS = 18
PT_SHADOW_OPS = 7
PT_QUAD_OPS = 30
PT_LIGHT_OPS = 78
PT_QUAD_GGX_OPS = 13
PT_LIGHT_RGB_OPS = (21, 48, 21, 84)

def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, reps, setup=None):
    """Mean milliseconds per call over ``reps`` calls after two warm-ups,
    from CUDA events; ``setup`` (untimed) runs before each call."""
    for _ in range(2):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    if setup is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    pairs = []
    for _ in range(reps):
        setup()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        pairs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def bound(nbytes, ops):
    """(least ms, what bounds it): bytes over the memory rate or FP32
    operations over the peak rate, whichever takes longer."""
    b_ms, o_ms = nbytes / MEM_BPS * 1e3, ops / FP32_OPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def cmp_level_into(torch, CW, scene, cfg, rays, tile, kinds, spawn=True,
                   tables=None, grid_bbox=None, what="K3"):
    """K3 as the tree loop launches it (``CW.level_into_kernel``: on a
    spawn level the combine's 10 rows and each child into the next
    level's streams, on the last the 4 rows) against
    ``CW.level_into_plain`` on one level's (11, n) ray streams.  A lane
    differs where its combine rows do (valid lanes; the hit flag exactly),
    where one of its children's valid rows does (every lane, exactly), or
    where a valid child's other rows do: points by 1e-5 of their
    magnitude, the rest by 2e-4.  The kernel's ``next`` starts as NaN, so
    a row the next level reads that K3 left unwritten differs.  At most
    LANE_BUDGET of the lanes may differ.  Returns (max abs err on the
    lanes that agree, share of lanes differing)."""
    n, b = rays.shape[1], len(kinds)
    valid = rays[10] != 0.0
    ref_next = torch.empty((11, b * n), device=rays.device) if spawn else None
    got_next = (torch.full_like(ref_next, float("nan")) if spawn
                else None)
    ref = CW.level_into_plain(scene, cfg, rays, ref_next, tile, kinds,
                              tables, grid_bbox)
    got = CW.level_into_kernel(scene, cfg, rays, got_next, tile, kinds,
                               tables, grid_bbox)
    torch.cuda.synchronize()
    rows = [k for k in range(ref.shape[0]) if k != 3]  # all but hit
    bad = ((ref[3] > 0.0) != (got[3] > 0.0)) | ~(
        (got[rows] - ref[rows]).abs() <= 2e-4).all(0)
    bad &= valid
    ok = valid & ~bad
    err = (float((got[:, ok] - ref[:, ok]).abs().max()) if bool(ok.any())
           else 0.0)
    if not spawn:
        share = float(bad.float().mean())
        check(share <= LANE_BUDGET, f"{what}: {share} of lanes differ")
        return err, share
    kid = ref_next[10] != 0.0
    lim = torch.full((10, 1), 2e-4, device=rays.device).expand(10, b * n)
    lim = torch.cat([1e-5 * torch.clamp(ref_next[0:3].abs().amax(0),
                                        min=1.0).expand(3, -1), lim[3:]])
    kid_bad = (got_next[10] != ref_next[10]) | (kid & ~(
        (got_next[:10] - ref_next[:10]).abs() <= lim).all(0))
    # child (j*b + k)*tile + r is of lane j*tile + r
    bad |= kid_bad.reshape(-1, b, tile).any(1).reshape(-1)
    share = float(bad.float().mean())
    check(share <= LANE_BUDGET, f"{what} into the next level's streams: "
          f"{share} of lanes differ")
    ok, kid_ok = valid & ~bad, kid & ~kid_bad
    if bool(ok.any()):
        err = float((got[:, ok] - ref[:, ok]).abs().max())
    if bool(kid_ok.any()):
        err = max(err, float((got_next[:10, kid_ok]
                              - ref_next[:10, kid_ok]).abs().max()))
    return err, share


def kernel_scene(SceneBuilder):
    b = SceneBuilder()
    b.set_camera([0, 1, 6], [0, 0, 0], [0, 1, 0], 45, 0.01, 16, 12, 0, 1)
    m0 = b.add_material([0.6, 0.6, 0.2], 0.8, [0.2, 0.2, 0.2], 0.0, 10, 0, 1)
    m1 = b.add_material([0.1, 0.9, 0.2], 0.0, [1, 1, 1], 0.5, 30, 1, 1.5)
    m2 = b.add_material([0.9, 0.1, 0.1], 0.9, [1, 1, 1], 0.3, 50, 0, 1)
    b.add_sphere([-0.8, 0, 0], 0.8, m2)
    b.add_plane_hessian([0, 1, 0], 1.0, m0)
    b.add_triangle([0, 0, 0], [1.5, 0, 0], [0, 1.5, 0.5], m1)
    b.add_box([1, -1, -1], [2, 0.5, 0], m2)
    b.add_sphere([0.5, 1.5, -1], 0.6, m1)
    b.add_triangle([-2, -1, -2], [2, -1, -2], [0, 2, -2], m0)
    b.add_box([-2.5, -0.5, 1], [-1.5, 0.5, 2], m1)
    b.add_plane_hessian([0, 0, 1], 4.0, m2)
    b.add_point_light([2, 4, 2], [1, 1, 1])
    b.add_quad_light([-2, 4, 2], [1, 1, 1], [-1, 4, 2], [-2, 4, 3], 4)
    return b.build()


def synthetic_faces(np, seed):
    """Six skybox faces of unequal sizes, each its own colour plus noise."""
    rng = np.random.default_rng(seed)
    sizes = [(8, 6), (5, 7), (6, 6), (4, 3), (7, 5), (6, 8)]
    faces = np.zeros((6, 8, 8, 3), np.float32)
    res = np.zeros((6, 2), np.int32)
    for i, (w, h) in enumerate(sizes):
        faces[i, :h, :w] = (np.eye(3)[i % 3] * 0.6
                            + 0.2 * rng.random((h, w, 3)))
        res[i] = (w, h)
    return faces, res


def without_lights(scene):
    """The scene with its lights taken out."""
    st = dataclasses.replace(scene.static, n_lights=0, light_quad=(),
                             light_grid=())
    return dataclasses.replace(scene, static=st, **{
        k: getattr(scene, k)[:0] for k in (
            "light_pos", "light_color", "light_e1", "light_e2",
            "light_is_quad", "light_grid_res")})


def ptxas_report(log, kernels):
    """{kernel: ptxas's lines for it} from the build log (``-Xptxas -v``):
    registers, static shared memory, stack and spills of each entry whose
    mangled name contains one of ``kernels``."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((k for k in kernels if k in line), None)
        elif cur and ("Used" in line or "spill" in line):
            out.setdefault(cur, []).append(line.split(":", 1)[-1].strip()
                                           if "Used" in line
                                           else line.strip())
    return out


def level_breakdown(torch, dev, card, scene, cfg, samples):
    """K3 at each level of the Whitted frame's middle tile (the first
    tiles are the floor's, where almost no child ray spawns): the streams
    that ``trace_whitted`` gives ``fused_level_into`` for that tile's
    ``tile_rays`` samples (level L holds tile x 2^L lanes), each level's
    valid share and its bare launch time as the tree loop launches it
    (children into the next level's streams), each level held to its
    plain version by :func:`cmp_level_into`.  Returns ([(lanes, valid
    share, ms)], the largest error of those comparisons)."""
    from distributionraytracer_tpu_torch.integrator.render import (
        _rays_from_samples,
    )
    from distributionraytracer_tpu_torch.integrator.whitted import (
        trace_whitted,
    )
    from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
    rays = _rays_from_samples(scene, cfg, samples)
    a = (-(-rays[0].shape[0] // cfg.tile_rays) // 2) * cfg.tile_rays
    o, d, t, ls = (x[a:a + cfg.tile_rays].contiguous() for x in rays)
    log, orig = [], CW.fused_level_into

    def recorder(sc, c, rays, nxt, tile, kinds, *args):
        log.append((rays.clone(), nxt is not None, tile, kinds))
        return orig(sc, c, rays, nxt, tile, kinds, *args)

    tb, n_obj, res = CW.level_tables(scene), scene.static.n_objects, []
    CW.fused_level_into = recorder
    try:
        trace_whitted(scene, cfg, o, d, t, ls, tables=tb)
    finally:
        CW.fused_level_into = orig
    err = 0.0
    for lv, (rays, spawn, tile, kinds) in enumerate(log):
        n = rays.shape[1]
        out = torch.empty((len(CW.COMBINE_ROWS) if spawn else 4, n),
                          device=dev)
        nxt = (torch.empty((11, len(kinds) * n), device=dev) if spawn
               else None)
        ms = timed_ms(torch, lambda: CW.launch_level(
            tb, n_obj, rays, cfg, spawn, out, None, nxt, tile, kinds), 20)
        share = float((rays[10] != 0.0).float().mean())
        e, m = cmp_level_into(torch, CW, scene, cfg, rays, tile, kinds,
                              spawn, tables=tb, what=f"K3 level {lv}")
        err = max(err, e)
        note = f"; vs plain: lanes differing {m:.2e}, max abs err {e:.3e}"
        print(f"K3 level {lv} (samples {a}:{a + cfg.tile_rays}): {n} lanes, "
              f"valid {share:.4f}, spawn {spawn}: "
              f"{ms:.4f} ms{note} | {card}")
        res.append((n, share, ms))
    return res, err


def bounce_breakdown(torch, card, pts, pcfg, paths, pt_frame,
                     cmp_pt_bounce=None, cmp_pt_trace=None):
    """K6 at each bounce of the path-traced frame's middle tile (the
    first tiles look at the floor, whose paths leave for the sky within two
    bounces): the camera rays and uniforms that one ``pt_frame()`` gives
    the looped K6 (``pt_trace``) for that tile (``render_pt`` runs its
    ``paths`` in tiles of ``pcfg.pt_tile_rays``), taken through the
    bounces one single-bounce K6 at a time; each bounce's live share and
    its bare launch time (the state restored, untimed, before each
    launch); ``cmp_pt_bounce`` (if given) holds each bounce to its plain
    version.  The looped K6 on the tile must give the replay's final
    colours bit for bit; ``cmp_pt_trace`` (if given) holds it to its plain
    version.  Returns [(live share, ms)] and the tile's record: its
    inputs, the state before each bounce, and the looped K6's error
    against its plain version."""
    from distributionraytracer_tpu_torch.ops import cuda_pt as CP
    from distributionraytracer_tpu_torch.scene.pt_scenes import SKY_GRADIENT
    B = pcfg.max_bounces
    k = -(-paths // pcfg.pt_tile_rays) // 2
    calls, orig = [], CP.pt_trace

    def recorder(sc, o, d, tm, uniforms, rr, **kw):
        calls.append((o, d, tm, uniforms, rr) if len(calls) == k else None)
        return orig(sc, o, d, tm, uniforms, rr, **kw)

    CP.pt_trace = recorder
    try:
        pt_frame()
    finally:
        CP.pt_trace = orig
    check(len(calls) > k, f"K6 breakdown: {len(calls)} looped launches, "
          f"no tile {k}")
    o, d, tm, uniforms, rr = calls[k]
    state, log = CP.bounce_state(o, d, tm), []
    for b in range(B):
        u = uniforms.bounce(b)
        uni = CP.bounce_streams(u.uch, u.u3a, u.u3b, u.urr, u.uq,
                                pts.qlight_pos.shape[0])
        log.append((state.clone(), uni, rr))
        CP.pt_bounce_kernel(pts, state, uni, rr)
    looped = CP.pt_trace_kernel(pts, o, d, tm, uniforms, rr)
    check(torch.equal(looped.col, state[CP.ST_COL].T),
          f"K6 breakdown: the looped K6's colours on tile {k} are not the "
          f"{B} single-bounce launches' final colours")
    if looped.mw is not None:
        check(torch.equal(looped.mw, state[CP.ST_MW].T)
              and torch.equal(looped.md, state[CP.ST_MD].T),
              f"K6 breakdown: the looped K6's latched misses on tile {k} "
              f"are not the single-bounce launches'")
    err, note = None, ""
    if cmp_pt_trace is not None:
        err, m, _ = cmp_pt_trace(pts, o, d, tm, uniforms, rr)
        note = (f"; vs {B} plain bounces: lanes differing {m:.2e}, max abs "
                f"err {err:.3e}")
    print(f"K6 looped launch (tile {k}): colours equal to {B} single-bounce "
          f"launches{note} | {card}")
    ptb, grad, res = CP.pt_tables(pts), pts.sky_mode == SKY_GRADIENT, []
    for b, (state, uni, rr) in enumerate(log):
        n = state.shape[1]
        live = float((state[CP.ST_ALIVE] > 0).float().mean())
        st = state.clone()
        ms = timed_ms(torch, lambda: CP.launch_bounce(ptb, st, uni, rr, grad),
                      20, setup=lambda: st.copy_(state))
        note = ""
        if cmp_pt_bounce is not None:
            check(rr, "K6 breakdown: the frame runs Russian roulette")
            e, m, _ = cmp_pt_bounce(pts, state, uni)
            note = f"; vs plain: lanes differing {m:.2e}, max abs err {e:.3e}"
        print(f"K6 bounce {b} (tile {k}): {n} paths, live {live:.4f}: "
              f"{ms:.4f} ms{note} | {card}")
        res.append((live, ms))
    rec = dict(o=o, d=d, time=tm, uniforms=uniforms, rr=rr,
               states=[st for st, _, _ in log], err=err, tile=k)
    return res, rec


def profile_frame(torch, render, wall_s, label, scopes=()):
    """One frame under torch.profiler: device-busy ms (the union of the
    device activity intervals), its idle share of the unprofiled frame time
    ``wall_s``, the host ops and the top device activities by name.
    Returns {device activity name: (count, ms)}; with ``scopes`` (names of
    ``record_function`` ranges that ``render`` opens), also {scope: the
    device kernels launched by the host ops inside its ranges, as
    {name: (count, ms)}}, and the busy ms.  Reads the profiler's raw
    events: turning a staged frame's ~1.6M host events into FunctionEvents
    takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    device, n_host, spans, ops = [], 0, {sc: {} for sc in scopes}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name not in spans:  # a scope's range on the device: no kernel
                device.append((e.start_ns(), e.end_ns(), name,
                               e.linked_correlation_id()))
            continue
        n_host += 1
        if name in spans:
            spans[name].setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns()))
        elif scopes and e.linked_correlation_id() == 0:  # a host op
            ops.append((e.start_thread_id(), e.start_ns(), e.end_ns(),
                        e.correlation_id()))
    scoped = {}
    for scope, by_thread in spans.items():
        # a device kernel links to the host op that launched it; the ops
        # inside a range of the scope (sorted by start, per thread)
        for v in by_thread.values():
            v.sort()
        starts = {th: [a for a, _ in v] for th, v in by_thread.items()}
        inside = set()
        for th, a, b, corr in ops:
            if th in by_thread:
                j = bisect.bisect_right(starts[th], a) - 1
                if j >= 0 and b <= by_thread[th][j][1]:
                    inside.add(corr)
        got = {}
        for a, b, name, link in device:
            if link in inside:
                n, ns = got.get(name, (0, 0))
                got[name] = (n + 1, ns + (b - a))
        scoped[scope] = {k: (n, ns / 1e6) for k, (n, ns) in got.items()}
        print(f"profile {label}: {sum(map(len, by_thread.values()))} "
              f"'{scope}' ranges, {len(inside)} host ops inside them "
              f"launched {sum(n for n, _ in got.values())} device kernels, "
              f"{sum(ns for _, ns in got.values()) / 1e6:.3f} ms: "
              + (", ".join(f"{k[:48]} {n} x {ns / 1e6:.3f} ms"
                           for k, (n, ns) in sorted(got.items()))
                 or "none"))
    if not device:
        print(f"profile {label}: the profiler traced no device activity; "
              "device-busy time and idle share not measured")
        return ({}, scoped, None) if scopes else {}
    busy_ns, end = 0, None
    by_name = {}
    for a, b, name, _ in sorted(device):
        lo = a if end is None else max(a, end)
        busy_ns += max(b - lo, 0)
        end = b if end is None else max(end, b)
        n, ns = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, ns + (b - a))
    busy_ms = busy_ns / 1e6
    print(f"profile {label}: device busy {busy_ms:.3f} ms of a "
          f"{wall_s * 1e3:.3f} ms frame (idle share "
          f"{1 - busy_ms / (wall_s * 1e3):.4f}); {len(device)} device "
          f"activities from {n_host} host events")
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    for name, (n, ns) in top[:10]:
        print(f"  {name[:64]:64s} {n:6d} x {ns / 1e6:9.3f} ms")
    out = {name: (n, ns / 1e6) for name, (n, ns) in by_name.items()}
    if scopes:
        return out, scoped, busy_ms
    return out


def kernel_sum(prof, kernel):
    """(launches, summed device ms) of the activities named ``kernel``."""
    hits = [v for k, v in prof.items() if kernel in k]
    return sum(n for n, _ in hits), sum(ms for _, ms in hits)


# ---------------------------------------------------------------------------
# Slice D: grid and BVH scenes (K7, K8, K9, K3 grid mode)
MESH = dict(n_tri=100_000, res=(512, 512), seed=0)  # the accelerated frame
SMALL_TRI = 1000  # 1,005 objects and no plane: the cost-brute route
ACCEL_SLAB = (240, 272)  # pixel rows of the accelerated frames' plain slab
NODE_OPS = 16  # a packet walk's node test: 12 sub/mul, 4 min/max
LANE_OPS = 3  # a packet lane's reciprocal direction
GRID_SLAB_OPS = 19  # K3 grid mode's slab over the grid box: 3 div, 12, 4
ACCEL_META = {
    "K7c": ("grouped_closest", "bvh.cu",
            "distributionraytracer_tpu/accel/pallas_packet.py:625"),
    "K7s": ("grouped_shadow", "bvh.cu",
            "distributionraytracer_tpu/accel/pallas_packet.py:625"),
    "K8c": ("legacy_closest", "bvh.cu",
            "distributionraytracer_tpu/accel/pallas_bvh.py:470"),
    "K8s": ("legacy_shadow", "bvh.cu",
            "distributionraytracer_tpu/accel/pallas_bvh.py:470"),
    "K9": ("binned_closest", "binned.cu",
           "distributionraytracer_tpu/accel/pallas_binned.py:768"),
    "K3g": ("fused_level_grid", "whitted_level.cu",
            "distributionraytracer_tpu/ops/pallas_whitted.py:320"),
    "K10": ("binned_shadow", "binned.cu",
            "distributionraytracer_tpu/accel/pallas_binned.py:812"),
    "K1c": ("closest_hit", "intersect.cu",
            "distributionraytracer_tpu/ops/pallas_intersect.py:331"),
}
# K10 per live lane: the origin's offset from the light (3 sub), the three
# frustum dot products (15), two divides, per axis the tile's divide, mul,
# add, max, min and mul (12), and the squared light distance (5).
LIGHT_TILE_OPS = 37


def recording(inter, log):
    """``inter`` that keeps the inputs of its first two closest queries
    (the primary level and level 1) and of its first shadow query."""
    from distributionraytracer_tpu_torch.integrator.whitted import (
        Intersectors,
    )
    calls = {"closest": 0, "shadow": 0}

    def closest(o, d, time, valid=None):
        calls["closest"] += 1
        if calls["closest"] <= 2:
            log[f"closest{calls['closest']}"] = (o, d, time, valid)
        return inter.closest(o, d, time, valid=valid)

    def shadow(o, d, dist, exclude_obj, valid=None):
        calls["shadow"] += 1
        if calls["shadow"] == 1:
            log["shadow1"] = (o, d, dist, valid)
        return inter.shadow(o, d, dist, exclude_obj, valid=valid)

    return Intersectors(closest, shadow)


def w_test_ops(torch, sc, o, d, time, mb):
    """(R, O) f64: the FP32 operations of each object test of each ray
    (``csrc/primitives.cuh``): W_TEST_OPS by type, one more for a sphere
    under motion blur, and W_SPHERE_MISS_OPS (+ motion blur) for a sphere
    whose discriminant is negative, computed as sphere_t does.  The first
    sphere in table order also carries the ray's d.d (W_FOLD_OPS), so that
    a sum along a fold counts it once if the fold reaches a sphere."""
    from distributionraytracer_tpu_torch.scene.types import OBJ_SPHERE
    data, types, _ = sc.packed_objects()
    data, types = data.to(o.device), types.to(o.device)
    mb1 = int(bool(mb))
    per = torch.tensor([W_TEST_OPS[t] + mb1 * (t == OBJ_SPHERE)
                        for t in sc.static.obj_types], dtype=torch.float64,
                       device=o.device)
    ops = per.expand(o.shape[0], per.shape[0]).clone()
    sph = types == OBJ_SPHERE
    if bool(sph.any()):
        c = data[sph, 0:3][None].expand(o.shape[0], -1, 3).clone()
        if mb:
            c[..., 1] = c[..., 1] + time[:, None]
        oc = o[:, None, :] - c
        a = (d * d).sum(-1)[:, None]
        b = 2.0 * (oc * d[:, None, :]).sum(-1)
        cq = (oc * oc).sum(-1) - data[sph, 3][None] ** 2
        disc = b * b - 4.0 * a * cq
        ops[:, sph] = torch.where(disc >= 0, float(W_TEST_OPS[0]),
                                  float(W_SPHERE_MISS_OPS)).double() + mb1
        ops[:, int(sph.float().argmax())] += W_FOLD_OPS
    return ops


def pt_test_ops(torch, PT, sc, o, d, time):
    """(K, R) f64: the FP32 operations of each primitive test of each ray
    in ``csrc/pt.cu``'s table order (triangles, spheres, moving spheres),
    a (moving) sphere's by the sign of its discriminant, computed as
    sph_t and msph_t do."""
    R, dev = o.shape[0], o.device
    rows = [torch.full((sc.tri_v0.shape[0], R), float(PT_TEST_OPS[0]),
                       dtype=torch.float64, device=dev)]
    a_dd = (d * d).sum(-1)
    for k, (c0, vel, rad) in enumerate((
            (sc.sph_center, None, sc.sph_radius),
            (sc.msph_c0, sc.msph_c1 - sc.msph_c0, sc.msph_radius))):
        if c0.shape[0] == 0:
            continue
        c = c0[:, None, :].expand(-1, R, 3)
        a = a_dd[None]
        oc = o[None] - c
        if vel is None:
            b = 2.0 * (oc * d[None]).sum(-1)
            cq = (oc * oc).sum(-1) - rad[:, None] ** 2
        else:  # the shader's quadratic in d1 = (c1 - c0) * EPS
            oc = oc - vel[:, None, :] * time[None, :, None]
            d1 = vel[:, None, :] * 1e-3
            dd1 = (d[None] * d1).sum(-1)
            a = a - dd1 * dd1
            oc_d, oc_d1 = (oc * d[None]).sum(-1), (oc * d1).sum(-1)
            b = 2.0 * (oc_d - oc_d1 * dd1)
            cq = (oc * oc).sum(-1) - oc_d1 * oc_d1 - rad[:, None] ** 2
        disc = b * b - 4.0 * a * cq
        rows.append(torch.where(disc >= 0, float(PT_TEST_OPS[1 + k]),
                                float(PT_MISS_TEST_OPS[1 + k])).double())
    return torch.cat(rows)


def type_ops(torch, type_tests, table=W_WALK_OPS):
    """FP32 operations of object tests counted by slot type + 1 (index 0:
    inert slots, which cost a compare)."""
    per = torch.tensor((0,) + tuple(table), dtype=torch.float64)
    return float((type_tests.double() * per).sum())


def winner_normal_ops(torch, sc, gid):
    """The winners' normals, once per hit lane (W_NORMAL_OPS by type)."""
    per = torch.tensor([W_NORMAL_OPS[t] for t in sc.static.obj_types],
                       dtype=torch.float64, device=gid.device)
    return float(per[gid[gid >= 0].long()].sum())


def grid_fold_ops(torch, sc, o, d, dist, lanes, gb):
    """K3 grid mode's shadow work on these rays: the slab over the grid
    box for every lane, then (where it succeeds) every test up to the first
    ``t < dist`` occluder; lanes only."""
    from distributionraytracer_tpu_torch.accel.grid import grid_slab
    from distributionraytracer_tpu_torch.ops.intersect import _type_tmats
    n_obj = sc.static.n_objects
    okm = torch.zeros((o.shape[0], n_obj), dtype=torch.bool,
                      device=o.device)
    zt = torch.zeros_like(dist)
    for _typ, gids, tmat in _type_tmats(sc, o, d, zt, False):
        okm[:, gids.long()] = tmat < dist[:, None]
    cum = torch.cumsum(w_test_ops(torch, sc, o, d, zt, False), 1)
    first = torch.where(okm.any(1), okm.float().argmax(1), n_obj - 1)
    slab_ok = grid_slab(*gb, o, d)[0]
    fold = cum.gather(1, first[:, None])[:, 0]
    fold = torch.where(slab_ok, fold, torch.zeros_like(fold))
    return float((fold + GRID_SLAB_OPS)[lanes].sum()), okm.any(1) | ~slab_ok


def k3_grid_ops(torch, CW, sc, cfg, o, d, t, ls, gb):
    """K3 grid mode's FP32 operations on one spawning level: the closest
    fold over every object and the slab gate, the lane's shading setup,
    per light its direction and the grid shadow (for gated hits), the
    shading of lit lights, and the spawn."""
    from distributionraytracer_tpu_torch.accel.grid import grid_slab
    from distributionraytracer_tpu_torch.ops.common import OFFSET
    from distributionraytracer_tpu_torch.ops.intersect import (
        closest_hit_brute,
    )
    n = o.shape[0]
    h = closest_hit_brute(sc, o, d, t, False)
    ok, *_, t1 = grid_slab(*gb, o, d)
    hit = h.hit & ok & (h.t < t1)
    ops = (float(w_test_ops(torch, sc, o, d, t, False).sum())
           + n * (GRID_SLAB_OPS + W_LANE_OPS))
    ops += winner_normal_ops(torch, sc, h.obj_id)
    p = o + d * torch.where(h.hit, h.t, torch.ones_like(h.t))[:, None]
    nn_ = CW._norm3(h.normal)
    N_ = nn_ * torch.where((d * nn_).sum(-1) < 0, 1.0, -1.0)[:, None]
    ltab = CW.level_tables(sc)
    for j in range(sc.static.n_lights):
        lp = ltab.lights[j, 0:3].expand(n, 3)
        if sc.static.light_quad[j]:
            lp = (lp + ltab.lights[j, 3:6] * ls[:, 0:1]
                  + ltab.lights[j, 6:9] * ls[:, 1:2])
            ops += n * W_QUAD_OPS
        ul = lp - p
        L_ = ul / torch.sqrt(torch.clamp((ul * ul).sum(-1), min=1e-24))[:,
                                                                       None]
        fold, occ = grid_fold_ops(torch, sc, p + N_ * OFFSET, L_,
                                  torch.ones(n, device=o.device), hit, gb)
        ops += fold + n * W_LIGHT_OPS + float((hit & ~occ).sum()) * W_SHADE_OPS
    ones = torch.ones(n, device=o.device)
    lv = CW.fused_level_plain(sc, cfg, o, d, t, ones, ls,
                              torch.ones_like(h.hit), True, tables=ltab,
                              grid_bbox=gb)
    ops += (n * W_SPAWN_OPS
            + float((~((d * nn_).sum(-1) < 0)).sum()) * W_BEER_OPS
            + float(lv["refr_valid"].sum()) * W_REFR_OPS
            + float(lv["refl_valid"].sum()) * W_REFL_OPS)
    return ops


def accel_phase(torch, np, dev, card, counted, mesh=MESH, slab=ACCEL_SLAB,
                small_tri=SMALL_TRI, frames=FRAMES):
    """The accelerated Whitted frame (``mesh_scene``, 100,000 triangles,
    512x512, spp 0, depth 4) on each route, between a reset and a read of
    the launch counters; 32-row slabs against plain torch; warm frames of
    the main route; its profile.  Returns what the kernel rows need."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_scenes import mesh_scene

    from distributionraytracer_tpu_torch import native
    from distributionraytracer_tpu_torch.accel import cuda_bvh as CBV
    from distributionraytracer_tpu_torch.accel import cuda_grid as CG
    from distributionraytracer_tpu_torch.config import RenderConfig
    from distributionraytracer_tpu_torch.integrator.render import (
        make_samples, render_from_samples,
    )
    from distributionraytracer_tpu_torch.renderer import (
        Renderer, _brute_bvh_intersectors,
    )
    from distributionraytracer_tpu_torch.scene import SceneBuilder
    from distributionraytracer_tpu_torch.scene.types import (
        ACCEL_BVH, ACCEL_GRID,
    )

    t0 = time.perf_counter()
    ok = native.available()
    print(f"native host builder: {native.builder()} "
          f"({time.perf_counter() - t0:.2f}s to build or load "
          "native/drt_native.cpp)")
    check(ok, "the native host builder did not build")

    cfg = RenderConfig(spp=0)
    W, H = mesh["res"]

    def renderer(label, accel, n_tri, **over):
        sc = mesh_scene(SceneBuilder, n_tri=n_tri, accel=accel,
                        seed=mesh["seed"], res=mesh["res"])
        r = Renderer(sc, cfg.replace(**over), device=dev)
        ab = r.accel_build
        print(f"accel build, {label}: {sc.static.n_objects} objects, "
              f"{ab.builder} builder, {ab.seconds:.2f}s; route "
              f"{r.executed_backend()}")
        check(ab.builder == "native", f"{label}: built by {ab.builder}")
        return r

    n = mesh["n_tri"]
    bvh = renderer("bvh", ACCEL_BVH, n)
    grid = renderer("grid", ACCEL_GRID, n)
    leg = renderer("bvh, packet_kernel='legacy'", ACCEL_BVH, n,
                   packet_kernel="legacy")
    cb = renderer("small bvh", ACCEL_BVH, small_tri)
    cbg = renderer("small grid", ACCEL_GRID, small_tri)
    for r, label in ((bvh, "binned-primary+grouped-packet"),
                     (grid, "binned-primary+grid-packet"),
                     (leg, "legacy-packet"), (cb, "cost-brute"),
                     (cbg, "cost-brute")):
        check(r.executed_backend() == label,
              f"route {r.executed_backend()}, not {label}")
    samples = make_samples(bvh.scene, cfg,
                           torch.Generator(device=dev).manual_seed(0))
    gb = (cbg.tabs.bbox_min, cbg.tabs.bbox_max)

    runs = {}

    def route(key, label, render, expect):
        out, got, secs = counted(label, render, expect)
        runs[key] = (got, dict(CBV.LAUNCHES), secs)
        img, nr = out
        check(tuple(img.shape) == (H, W, 3), f"{key} image shape")
        check(bool(torch.isfinite(img).all()), f"{key}: non-finite pixels")
        check(float(img.std()) > 0.05, f"{key}: constant image")
        return img, nr

    img_b, rays_b = route(
        "bvh", "accelerated main path, Renderer.render_with_samples "
        "(binned-primary+grouped-packet)",
        lambda: bvh.render_with_samples(samples, return_rays=True),
        {"K7": True, "K9": True})
    check(runs["bvh"][0]["K9"] == 1, "K9 is launched once, on the primary "
          f"level, not {runs['bvh'][0]['K9']} times")
    img_g, _ = route(
        "grid", "Renderer.render_with_samples on the grid scene "
        "(binned-primary+grid-packet)",
        lambda: grid.render_with_samples(samples, return_rays=True),
        {"K7": True, "K9": True})
    img_l, rays_l = route(
        "legacy", "Renderer.render_with_samples, packet_kernel='legacy' "
        "(legacy-packet)",
        lambda: leg.render_with_samples(samples, return_rays=True),
        {"K8": True})
    check(rays_l == rays_b, f"ray counts: legacy {int(rays_l)}, grouped "
          f"{int(rays_b)}")
    img_cb, _ = route(
        "cost-brute", "Renderer.render_with_samples, 1,005 objects "
        "(cost-brute, bvh)",
        lambda: cb.render_with_samples(samples, return_rays=True),
        {"K1": True, "K2": True})
    img_cbg, _ = route(
        "cost-brute-grid", "Renderer.render_with_samples, 1,005 objects "
        "(cost-brute, grid)",
        lambda: cbg.render_with_samples(samples, return_rays=True),
        {"K1": True, "K2": True})
    img_fg, _ = route(
        "fused-grid", "render_from_samples(..., fused_grid=) on the 1,005 "
        "objects grid scene (K3 grid mode)",
        lambda: render_from_samples(cbg.scene, cfg, samples,
                                    return_rays=True, fused_grid=gb),
        {"K3grid": True})

    # plain torch on rows a:b of the same SampleSet
    a, b = slab
    part = samples.rows(a, b)
    off = cfg.replace(kernels="off")
    t0 = time.perf_counter()
    plain_b = render_from_samples(
        bvh.scene, off, part, row_offset=a,
        inter=CBV.packet_intersectors(bvh.scene, bvh.tabs, plain=True))
    plain_g = render_from_samples(
        grid.scene, off, part, row_offset=a,
        inter=CG.make_cuda_grid_intersectors(grid.scene, grid.tabs,
                                             plain=True))
    plain_cb = render_from_samples(
        cb.scene, off, part, row_offset=a,
        inter=_brute_bvh_intersectors(cb.scene, off))
    plain_cbg = render_from_samples(
        cbg.scene, off, part, row_offset=a,
        inter=CG.make_brute_grid_intersectors(cbg.scene, cbg.tabs,
                                              plain=True))
    plain_fg = render_from_samples(cbg.scene, off, part, row_offset=a,
                                   fused_grid=gb)
    print(f"plain torch slabs (rows {a}:{b}, five routes): "
          f"{time.perf_counter() - t0:.2f}s")
    for name, got, ref in (("binned-primary+grouped-packet", img_b, plain_b),
                           ("binned-primary+grid-packet", img_g, plain_g),
                           ("legacy-packet", img_l, plain_b),
                           ("cost-brute bvh", img_cb, plain_cb),
                           ("cost-brute grid", img_cbg, plain_cbg),
                           ("fused grid level", img_fg, plain_fg)):
        diff = (got[a:b] - ref).abs()
        out = float((diff > 3e-3).float().mean())
        check(out <= 0.005 and float(diff.max()) <= 0.05,
              f"{name} slab vs plain: {out:.4%} beyond 3e-3, max "
              f"{float(diff.max()):.4f}")
        print(f"mesh frame rows {a}:{b} {name} kernels vs plain torch: "
              f"{out:.4%} of elements beyond 3e-3, max diff "
              f"{float(diff.max()):.4f}  PASS")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        img2, rays2 = bvh.render_with_samples(samples, return_rays=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(torch.equal(img_b, img2) and int(rays_b) == int(rays2),
              "two accelerated renders of one SampleSet differ")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times)
    print(f"accelerated frame 512x512 spp0 depth4, 100,005 objects "
          f"(binned-primary+grouped-packet): {len(times)} warm frames "
          f"{' '.join(f'{x:.4f}' for x in times)} s (median {med:.4f}, min "
          f"{min(times):.4f}, max {max(times):.4f}; first "
          f"{runs['bvh'][2]:.4f} s), {int(rays_b)} rays, "
          f"{int(rays_b) / med:.4e} rays/s at the median, peak "
          f"{peak:.2f} GiB | {card}")
    for key in ("grid", "legacy"):
        print(f"accelerated frame, {key} route: {runs[key][2]:.4f} s (one "
              f"frame) | {card}")
    return dict(bvh=bvh, grid=grid, leg=leg, cb=cb, cbg=cbg, samples=samples,
                gb=gb, runs=runs, median=med, cfg=cfg, img_g=img_g)


def light_phase(torch, np, dev, card, counted, mesh=MESH, slab=ACCEL_SLAB,
                frames=FRAMES):
    """The accelerated frame with a finite ground on the binned+ routes (K10
    on the primary shadow query) and on the switched-off BVH route, between
    resets and reads of the launch counters; 32-row slabs against plain
    torch; alternating warm frames of the binned+ and switched-off BVH
    routes.  Returns what K10's row and the profiles need."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_scenes import mesh_scene

    from distributionraytracer_tpu_torch.accel import cuda_binned as CBN
    from distributionraytracer_tpu_torch.accel import cuda_bvh as CBV
    from distributionraytracer_tpu_torch.accel import cuda_grid as CG
    from distributionraytracer_tpu_torch.config import RenderConfig
    from distributionraytracer_tpu_torch.integrator.render import (
        make_samples, render_from_samples,
    )
    from distributionraytracer_tpu_torch.renderer import Renderer
    from distributionraytracer_tpu_torch.scene import SceneBuilder
    from distributionraytracer_tpu_torch.scene.types import (
        ACCEL_BVH, ACCEL_GRID,
    )

    cfg = RenderConfig(spp=0)
    W, H = mesh["res"]

    def renderer(label, accel, binning):
        sc = mesh_scene(SceneBuilder, n_tri=mesh["n_tri"], accel=accel,
                        seed=mesh["seed"], res=mesh["res"], ground="box")
        CBN.SHADOW_BINNING = binning
        try:
            r = Renderer(sc, cfg, device=dev)
        finally:
            CBN.SHADOW_BINNING = False
        print(f"box-ground frame, {label}: {sc.static.n_objects} objects, "
              f"{r.accel_build.builder} builder, {r.accel_build.seconds:.2f}s;"
              f" route {r.executed_backend()}")
        return r

    bvh = renderer("bvh, light bins", ACCEL_BVH, True)
    grid = renderer("grid, light bins", ACCEL_GRID, True)
    off = renderer("bvh, SHADOW_BINNING off", ACCEL_BVH, False)
    for r, label in ((bvh, "binned+grouped-packet"),
                     (grid, "binned+grid-packet"),
                     (off, "binned-primary+grouped-packet")):
        check(r.executed_backend() == label,
              f"route {r.executed_backend()}, not {label}")
    for r, name in ((bvh, "bvh"), (grid, "grid")):
        t0 = time.perf_counter()
        lb = CBN.build_light_bins(r.scene, r._gbox)
        secs = time.perf_counter() - t0
        check(torch.equal(lb.tile_start, r._light_bins.tile_start.cpu()),
              f"{name}: light bins differ between two builds")
        print(f"build_light_bins ({name}, host, {r._gbox.shape[0]} groups, "
              f"K={lb.k}): {secs:.4f} s, {int(lb.tile_start[-1])} entries "
              f"over {lb.n_lights} lights")
    samples = make_samples(bvh.scene, cfg,
                           torch.Generator(device=dev).manual_seed(0))
    runs = {}

    def route(key, label, r, expect):
        (img, nr), got, secs = counted(
            label, lambda: r.render_with_samples(samples, return_rays=True),
            expect)
        runs[key] = (got, secs, img, nr)
        check(tuple(img.shape) == (H, W, 3), f"{key} image shape")
        check(bool(torch.isfinite(img).all()), f"{key}: non-finite pixels")
        check(float(img.std()) > 0.05, f"{key}: constant image")

    lit = {"K7": True, "K9": True, "K10": True}
    route("bvh+", "box-ground frame, Renderer.render_with_samples "
          "(binned+grouped-packet)", bvh, lit)
    route("grid+", "box-ground grid frame, Renderer.render_with_samples "
          "(binned+grid-packet)", grid, lit)
    route("off", "box-ground frame, SHADOW_BINNING off "
          "(binned-primary+grouped-packet)", off, {"K7": True, "K9": True})
    for key in ("bvh+", "grid+"):
        got = runs[key][0]
        check(got["K9"] == 1 and got["K10"] == 1,
              f"{key}: K9 {got['K9']}, K10 {got['K10']} launches, not 1, 1")
    check(int(runs["bvh+"][3]) == int(runs["off"][3]),
          "ray counts of the binned+ and binned-primary+ frames differ")

    a, b = slab
    part = samples.rows(a, b)
    noff = cfg.replace(kernels="off")
    t0 = time.perf_counter()
    plain_b = render_from_samples(
        bvh.scene, noff, part, row_offset=a,
        inter=CBV.packet_intersectors(bvh.scene, bvh.tabs, plain=True))
    plain_g = render_from_samples(
        grid.scene, noff, part, row_offset=a,
        inter=CG.make_cuda_grid_intersectors(grid.scene, grid.tabs,
                                             plain=True))
    print(f"plain torch slabs (rows {a}:{b}, box ground, two scenes): "
          f"{time.perf_counter() - t0:.2f}s")
    for name, key, ref in (("binned+grouped-packet", "bvh+", plain_b),
                           ("binned+grid-packet", "grid+", plain_g),
                           ("binned-primary+grouped-packet", "off", plain_b)):
        diff = (runs[key][2][a:b] - ref).abs()
        out = float((diff > 3e-3).float().mean())
        check(out <= 0.005 and float(diff.max()) <= 0.05,
              f"{name} (box ground) slab vs plain: {out:.4%} beyond 3e-3, "
              f"max {float(diff.max()):.4f}")
        print(f"box-ground frame rows {a}:{b} {name} kernels vs plain torch: "
              f"{out:.4%} of elements beyond 3e-3, max diff "
              f"{float(diff.max()):.4f}  PASS")

    times = {"bvh+": [], "off": []}
    peak = {"bvh+": 0.0, "off": 0.0}
    for _ in range(frames):
        for key, r in (("bvh+", bvh), ("off", off)):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            img2, rays2 = r.render_with_samples(samples, return_rays=True)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
            peak[key] = max(peak[key],
                            torch.cuda.max_memory_allocated() / 2**30)
            check(torch.equal(img2, runs[key][2])
                  and int(rays2) == int(runs[key][3]),
                  f"{key}: two renders of one SampleSet differ")
    med = {}
    for key, label in (("bvh+", "binned+grouped-packet"),
                       ("off", "binned-primary+grouped-packet")):
        ts = times[key]
        med[key] = statistics.median(ts)
        nr = int(runs[key][3])
        print(f"box-ground frame 512x512 spp0 depth4 ({label}): {len(ts)} "
              f"warm frames {' '.join(f'{x:.4f}' for x in ts)} s (median "
              f"{med[key]:.4f}, min {min(ts):.4f}, max {max(ts):.4f}; first "
              f"{runs[key][1]:.4f} s), {nr} rays, {nr / med[key]:.4e} rays/s "
              f"at the median, peak {peak[key]:.2f} GiB | {card}")
    print(f"box-ground grid frame (binned+grid-packet): {runs['grid+'][1]:.4f}"
          f" s (one frame) | {card}")
    return dict(bvh=bvh, grid=grid, off=off, samples=samples, runs=runs,
                median=med)


def light_rows(torch, dev, card, st, errs, add_row):
    """K10 against its plain version in both shadow modes and against K7's
    any-hit on each binned+ route's own primary shadow inputs, its work
    list (items of at most E entries) against its plain version, its bare
    launch per route, and K10's row (the BVH route's inputs)."""
    from distributionraytracer_tpu_torch.accel import cuda_binned as CBN
    from distributionraytracer_tpu_torch.accel import cuda_bvh as CBV
    from distributionraytracer_tpu_torch.accel.bvh import threaded_walk
    from distributionraytracer_tpu_torch.integrator.render import (
        render_from_samples,
    )

    samples = st["samples"]
    errs["K10"] = 0.0
    row = None
    for key, mode in (("bvh", "bvh"), ("grid", "grid")):
        r = st[key]
        sc = r.scene
        plan = r._plan(samples)
        log = {}
        render_from_samples(sc, r.cfg, samples, plan=plan._replace(
            inter=recording(plan.inter, log)))
        o, d, dist, valid = log["shadow1"]
        nl = o.shape[0]
        lid = CBN.shadow_light_ids(nl, sc.static.n_lights, dev)
        check(lid is not None, f"{key}: the primary shadow batch of {nl} "
              "lanes does not hold one light a chain")
        tabs = r.tabs.tabs if key == "grid" else r.tabs
        lb = plan.bins.lights
        types = tuple(sorted(set(sc.static.obj_types)))
        differing = {}
        for m in (mode, "grid" if mode == "bvh" else "bvh"):
            occ = CBN.binned_shadow_kernel(tabs, lb, lid, o, d, dist, valid,
                                           m)
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = CBN.binned_shadow_plain(tabs, lb, lid, o, d, dist, valid, m,
                                          types, stats)
            torch.cuda.synchronize()
            if m == mode:
                plain_s, own, own_stats = time.perf_counter() - t0, occ, stats
            differing[m] = int((occ != ref).sum())
            check(differing[m] == 0, f"K10 ({m} mode, binned+ {key} route): "
                  f"{differing[m]} lanes differ from the plain version")
        occ, stats = own, own_stats
        live = int(valid.sum())
        ce = stats["chain_entries"].double()
        print(f"K10 ({mode} mode) vs plain, binned+ {key} route, on {nl} "
              f"lanes ({live} live, {nl // 128} chains): occlusion equal "
              f"({float(occ[valid].float().mean()):.3f} occluded), "
              f"{stats['entries']} entries streamed (a chain: mean "
              f"{float(ce.mean()):.1f}, median {float(ce.median()):.0f}, "
              f"99th percentile {float(ce.quantile(0.99)):.0f}, max "
              f"{int(ce.max())}), {stats['obj_tests']} object tests; plain "
              f"{plain_s:.2f} s  PASS")
        launch, got, last_work = binned_shadow_launch(
            torch, CBN, tabs, lb, lid, o, d, dist, valid, mode)
        launch()
        check(torch.equal(got, occ), f"K10 ({key}): a bare launch differs "
              "from the wrapper's")
        E, work = CBN.ITEM_ENTRIES, last_work()
        plain = CBN.shadow_work_plain(lb, lid, o, valid)
        nrow = (plain.chains[:, 4] - plain.chains[:, 3] + 1).clamp(min=0)
        upto = (torch.arange(lb.k + 1, device=dev)[None, :]
                <= nrow[:, None])
        same = (torch.equal(work.chains, plain.chains)
                and torch.equal(work.item_start, plain.item_start)
                and torch.equal(torch.where(upto, work.rows, 0),
                                plain.rows))
        check(same, f"K10 ({key}): the kernel's work list differs from "
              "shadow_work_plain's")
        it, _ = CBN.shadow_item_entries(lb, plain)
        items, most = int(plain.item_start[-1]), int(
            torch.bincount(it).max())
        check(most <= E, f"K10 ({key}): an item streams {most} > E")
        split_s = (f"E {E}, {items} work items over {nl // 128} chains "
                   f"({int(plain.chains[:, 6].sum())} stream positions, "
                   f"{it.numel()} entries), most entries an item streams "
                   f"{most}, work list equal to shadow_work_plain's")
        ms = timed_ms(torch, launch, 20)
        print(f"K10 binned+ {key} route: {split_s}; bare launch {ms:.4f} ms; "
              f"lanes differing {differing['bvh']} (bvh mode), "
              f"{differing['grid']} (grid mode) | {card}")
        walk = CBV.packet_shadow_kernel(tabs, o, d, dist, valid,
                                        shadow_mode=mode)
        diff = int((walk != occ)[valid].sum())
        check(diff <= 0.002 * live, f"K10 vs K7 ({mode} mode): {diff} of "
              f"{live} live lanes differ")
        print(f"K10 vs K7 shadow ({mode} mode), binned+ {key} route: {diff} "
              f"of {live} live lanes differ  PASS")
        if key == "bvh":
            row = (tabs, lb, lid, o, d, dist, valid, stats, plain_s, launch)

    tabs, lb, lid, o, d, dist, valid, stats, plain_s, k10_bare = row
    nl = o.shape[0]
    # K10's bound: the least work that gives this occlusion, the smaller of
    # its own stream (each lane's tests up to its first occluder, each bin
    # entry and group streamed read once) and the packet walk's on the same
    # lanes (as K7's shadow row)
    wst = {}
    types = tuple(sorted(set(st["bvh"].scene.static.obj_types)))
    threaded_walk(tabs, o, d, None, valid, shadow_dist=dist,
                  types_present=types, stats=wst)
    own = (nl * (4 * 7 + 1 + 4 + 1)
           + (lb.tile_start.numel() + lb.frames.numel()) * 4
           + stats["bin_entries"] * 8 + stats["groups"] * 8 * 64,
           type_ops(torch, stats["type_tests"])
           + int(valid.sum()) * LIGHT_TILE_OPS)
    walk = (nl * (4 * 8 + 1) + (tabs.nodes.numel() + tabs.objs.numel()) * 4,
            nl * LANE_OPS + wst["node_tests"] * NODE_OPS
            + type_ops(torch, wst["type_tests"]))
    for name, (nb, ops) in (("its own stream", own), ("the walk", walk)):
        b_ms, b_by = bound(nb, ops)
        print(f"K10 bound by {name}: {b_ms:.4f} ms by {b_by} "
              f"({nb / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
    nbytes, ops = min(own, walk, key=lambda w: bound(*w)[0])
    rays = CBV._rays(o, d, dist, valid)
    occ_out = torch.empty((nl,), dtype=torch.bool, device=dev)
    add_row("K10", st["runs"]["bvh+"][0]["K10"], "binned+ route frame", nl,
            k10_bare,
            lambda: CBN.binned_shadow_kernel(tabs, lb, lid, o, d, dist, valid),
            plain_s * 1e3, nbytes, ops,
            f"{nl} primary shadow lanes in {nl // 128} chains, "
            f"{stats['entries']} entries streamed ({stats['bin_entries']} "
            f"distinct, {stats['groups']} groups); the walk tests "
            f"{wst['node_tests']} nodes and {wst['obj_tests']} objects")
    k7_bare = lambda: CBV.launch_packet_shadow(tabs, rays, False, "bvh",
                                               occ_out)
    k10_ms = timed_ms(torch, k10_bare, 20)
    k7_ms = timed_ms(torch, k7_bare, 20)
    print(f"K10 against K7 shadow on the binned+ route's primary shadow "
          f"batch ({nl} lanes), bare launches back to back: K10 "
          f"{k10_ms:.4f} ms, K7 {k7_ms:.4f} ms (K10 / K7 "
          f"{k10_ms / k7_ms:.3f}) | {card}")


def chain_skew(torch, label, stats, pb, card):
    """Prints how K9's work spreads over its chains on one batch, from the
    plain version's per-chain counts: groups streamed and slot tests
    (median, 90th percentile, maximum, the chain with the most, and its
    share of the whole), beside the candidate lists' lengths."""
    cnt = (pb.chain_start[1:] - pb.chain_start[:-1]).cpu().long()
    q = lambda x, p: float(torch.quantile(x.double(), p))
    parts = []
    for name, x in (("groups streamed", stats["chain_groups"]),
                    ("slot tests", stats["chain_tests"]),
                    ("candidates listed", cnt)):
        c, top, tot = int(x.argmax()), int(x.max()), int(x.sum())
        parts.append(f"{name} median {q(x, 0.5):.0f}, p90 {q(x, 0.9):.0f}, "
                     f"max {top} (chain {c}: {top / max(tot, 1):.5f} of "
                     f"{tot}, {top * x.numel() / max(tot, 1):.1f}x the "
                     "mean)")
    print(f"K9 chain skew, {label}, {cnt.numel()} chains: "
          + "; ".join(parts) + f" | {card}")


def accel_rows(torch, np, dev, card, st, errs, add_row):
    """K7, K8, K9 and K3 grid mode against their plain versions at the
    main path's shapes, and their rows (bare launch, wrapper, plain,
    bound from the plain walks' own counts)."""
    from distributionraytracer_tpu_torch.accel import cuda_binned as CBN
    from distributionraytracer_tpu_torch.accel import cuda_bvh as CBV
    from distributionraytracer_tpu_torch.accel.bvh import threaded_walk
    from distributionraytracer_tpu_torch.integrator.render import (
        _rays_from_samples, render_from_samples,
    )
    from distributionraytracer_tpu_torch.integrator.whitted import (
        _tree_shape,
    )
    from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
    from distributionraytracer_tpu_torch.ops import cuda_whitted as CW

    bvh, samples, cfg = st["bvh"], st["samples"], st["cfg"]
    W, H = bvh.scene.static.res_x, bvh.scene.static.res_y
    plan = bvh._plan(samples)
    bins = plan.bins
    log = {}
    render_from_samples(bvh.scene, bvh.cfg, samples, plan=plan._replace(
        inter=recording(plan.inter, log)))
    torch.cuda.synchronize()
    f4 = lambda k: 4 * k
    types = tuple(sorted(set(bvh.scene.static.obj_types)))

    def table_bytes(tabs):
        return (tabs.nodes.numel() + tabs.objs.numel()) * 4

    def check_closest(k, got, ref, valid, where="main path"):
        (t, nrm, gid), (rt, rn, rid) = got, ref
        check(torch.equal(gid[valid], rid[valid]),
              f"{k} ({where}): {int((gid != rid)[valid].sum())} lanes differ "
              "in id")
        check(bool((gid[~valid] == -1).all()), f"{k} ({where}): a lane "
              "that is not valid reports a hit")
        hit = valid & (rid >= 0)
        et = float(((t - rt).abs() / rt.abs().clamp(min=1.0))[hit].max())
        check(et <= 1e-5, f"{k} ({where}): t off by {et:.2e} relative")
        en = float((nrm - rn).abs()[hit].max())
        check(en <= 2e-5, f"{k} ({where}): normals off by {en:.2e}")
        err = max(float((t - rt).abs()[hit].max()), en)
        errs[k] = max(errs.get(k, 0.0), err)
        print(f"{k} vs plain, {where}, on {int(valid.sum())} lanes: ids "
              f"equal, max abs err {err:.3e} (t relative {et:.2e})  PASS")

    def check_shadow(k, tabs, o, d, dist, valid, mode, where="main path"):
        occ = CBV.packet_shadow_kernel(tabs, o, d, dist, valid,
                                       shadow_mode=mode)
        stats = {}
        ref = threaded_walk(tabs, o, d, None, valid, shadow_dist=dist,
                            shadow_mode=mode, types_present=types,
                            stats=stats)
        bad = int((occ != ref)[valid].sum())
        check(bad == 0, f"{k} shadow ({mode} mode, {where}): {bad} lanes "
              "differ")
        print(f"{k} shadow ({mode} mode) vs plain, {where}, on "
              f"{int(valid.sum())} lanes: occlusion equal "
              f"({float(ref[valid].float().mean()):.3f} occluded)  PASS")
        return stats

    # ---- K9 on the primary level ----
    o, d, t, valid = log["closest1"]
    valid = torch.ones_like(t, dtype=torch.bool) if valid is None else valid
    pb = bins.primary
    got = CBN.binned_closest_kernel(bvh.tabs, pb, o, d, t, valid)
    stats = {}
    ref = CBN.binned_closest_plain(bvh.tabs, pb, o, d, t, valid,
                                   types_present=types, stats=stats)
    check_closest("K9", got, ref, valid)
    chain_skew(torch, "BVH main path", stats, pb, card)
    launch9, got9, work9 = binned_closest_launch(torch, CBN, bvh.tabs, pb, o,
                                                 d, t, valid)
    launch9()
    check_closest("K9", got9(), ref, valid, "main path, bare launch")
    plain = CBN.closest_work_plain(pb)
    check(torch.equal(work9().item_start, plain.item_start),
          "K9: its work list differs from closest_work_plain's")
    units = CBN.closest_units_plain(pb, plain)
    print(f"K9 segments of {CBN.SEGMENT_GROUPS} groups: "
          f"{int(plain.item_start[-1])} tail items over {pb.n_chains} "
          f"chains, {units[0].numel()} warp units; work list equal to "
          f"closest_work_plain's | {card}")
    nl = o.shape[0]
    # K9 reads o, d, time, valid (a byte) and writes t, normal, object id
    add_row("K9", st["runs"]["bvh"][0]["K9"], "accelerated main path frame",
            nl, launch9,
            lambda: CBN.binned_closest_kernel(bvh.tabs, pb, o, d, t, valid),
            lambda: CBN.binned_closest_plain(bvh.tabs, pb, o, d, t, valid,
                                             types_present=types),
            nl * (f4(7 + 5) + 1) + bvh.tabs.objs.numel() * 4
            + sum(x.numel() * 4 for x in pb),
            type_ops(torch, stats["type_tests"])
            + winner_normal_ops(torch, bvh.scene, ref[2]),
            f"{nl} primary rays in {pb.n_chains} chains, "
            f"{stats['groups']} groups streamed")

    # ---- K7 and K8 on level 1 (closest) and the primary shadows ----
    for kk, r, run_key in (("K7", bvh, "bvh"), ("K8", st["leg"], "legacy")):
        tabs = r.tabs
        o, d, t, valid = log["closest2"]
        got = CBV.packet_closest_kernel(tabs, o, d, t, valid)
        stats = {}
        ref = threaded_walk(tabs, o, d, t, valid, types_present=types,
                            stats=stats)
        check_closest(kk + "c", got, ref, valid)
        rays = CBV._rays(o, d, t, valid)
        nl = o.shape[0]
        of = torch.empty((4, nl), device=dev)
        oi = torch.empty((nl,), dtype=torch.int32, device=dev)
        launches = st["runs"][run_key][1]
        walk = "grouped" if kk == "K7" else "legacy"
        add_row(kk + "c", launches[walk + "_closest"],
                f"{run_key} route frame", nl,
                lambda: CBV.launch_packet_closest(tabs, rays, False, of, oi),
                lambda: CBV.packet_closest_kernel(tabs, o, d, t, valid),
                lambda: threaded_walk(tabs, o, d, t, valid,
                                      types_present=types),
                nl * f4(8 + 5) + table_bytes(tabs),
                nl * LANE_OPS + stats["node_tests"] * NODE_OPS
                + type_ops(torch, stats["type_tests"])
                + winner_normal_ops(torch, r.scene, ref[2]),
                f"{nl} level-1 lanes ({int(valid.sum())} live), "
                f"{tabs.n_nodes} nodes")
        o, d, dist, valid = log["shadow1"]
        modes = ("grid", "bvh") if kk == "K7" else ("bvh",)
        for mode in modes:  # the bvh mode's counts make the bound
            stats = check_shadow(kk, tabs, o, d, dist, valid, mode)
        errs[kk + "s"] = 0.0
        rays = CBV._rays(o, d, dist, valid)
        nl = o.shape[0]
        occ_out = torch.empty((nl,), dtype=torch.bool, device=dev)
        add_row(kk + "s", launches[walk + "_shadow"], f"{run_key} route frame",
                nl,
                lambda: CBV.launch_packet_shadow(tabs, rays, False, "bvh",
                                                 occ_out),
                lambda: CBV.packet_shadow_kernel(tabs, o, d, dist, valid),
                lambda: threaded_walk(tabs, o, d, None, valid,
                                      shadow_dist=dist, types_present=types),
                nl * (f4(8) + 1) + table_bytes(tabs),
                nl * LANE_OPS + stats["node_tests"] * NODE_OPS
                + type_ops(torch, stats["type_tests"]),
                f"{nl} primary-level shadow lanes ({int(valid.sum())} live)")

    # ---- K9 and K7 on the grid route's own inputs and emulation tree ----
    grid = st["grid"]
    gplan = grid._plan(samples)
    gbins = gplan.bins
    glog = {}
    render_from_samples(grid.scene, grid.cfg, samples, plan=gplan._replace(
        inter=recording(gplan.inter, glog)))
    torch.cuda.synchronize()
    gtabs, where = grid.tabs.tabs, "grid route"
    o, d, t, valid = glog["closest1"]
    valid = torch.ones_like(t, dtype=torch.bool) if valid is None else valid
    gstats = {}
    check_closest("K9", CBN.binned_closest_kernel(gtabs, gbins.primary, o, d,
                                                  t, valid),
                  CBN.binned_closest_plain(gtabs, gbins.primary, o, d, t,
                                           valid, types_present=types,
                                           stats=gstats),
                  valid, where)
    chain_skew(torch, "grid route", gstats, gbins.primary, card)
    o, d, t, valid = glog["closest2"]
    check_closest("K7c", CBV.packet_closest_kernel(gtabs, o, d, t, valid),
                  threaded_walk(gtabs, o, d, t, valid, types_present=types),
                  valid, where)
    o, d, dist, valid = glog["shadow1"]
    check_shadow("K7", gtabs, o, d, dist, valid, "grid", where)

    # ---- K3 grid mode: one tile of the fused grid route's first level ----
    cbg, gb = st["cbg"], st["gb"]
    sc = cbg.scene
    o, d, t, ls = (x[:cfg.tile_rays].contiguous()
                   for x in _rays_from_samples(sc, cfg, samples))
    nl = o.shape[0]
    ones = torch.ones(nl, device=dev)
    ltab = CW.level_tables(sc)
    # level 0 of the tile as the tree loop launches it: one node of nl rays
    kinds = _tree_shape(sc, cfg)[0]
    rays3 = CI.ray_streams(nl, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                           d[:, 2], t, ones, ls[:, 0], ls[:, 1], ones)
    err, share = cmp_level_into(torch, CW, sc, cfg, rays3, nl, kinds,
                                tables=ltab, grid_bbox=gb,
                                what="K3 grid mode")
    errs["K3g"] = err
    print(f"K3 fused_level_into grid mode vs plain on {nl} lanes: lanes "
          f"differing {share:.2e}, max abs err {err:.3e}  PASS")
    nk = len(kinds)
    out3 = torch.empty((len(CW.COMBINE_ROWS), nl), device=dev)
    next3 = torch.empty((11, nk * nl), device=dev)
    gbox = CW.grid_box(gb, dev)
    n_obj = sc.static.n_objects
    add_row("K3g", st["runs"]["fused-grid"][0]["K3grid"], "fused grid route "
            "frame", nl,
            lambda: CW.launch_level(ltab, n_obj, rays3, cfg, True, out3,
                                    gbox, next3, nl, kinds),
            lambda: CW.level_into_kernel(sc, cfg, rays3, next3, nl, kinds,
                                         tables=ltab, grid_bbox=gb),
            lambda: CW.level_into_plain(sc, cfg, rays3, next3, nl, kinds,
                                        tables=ltab, grid_bbox=gb),
            nl * f4(11 + 10 + 11 * nk) + n_obj * f4(12 + 1 + 13)
            + sc.static.n_lights * f4(10) + f4(6),
            k3_grid_ops(torch, CW, sc, cfg, o, d, t, ls, gb),
            f"{nl} lanes of level 0, {n_obj} objects, spawn")


# ---------------------------------------------------------------------------
# K7 and K8 at each launch of their frames
WALK_KERNELS = ("grouped_closest_kernel", "grouped_shadow_kernel",
                "legacy_closest_kernel", "legacy_shadow_kernel")


def record_walks(torch, render):
    """Runs ``render`` once with K7/K8's launch functions wrapped: returns
    each launch, in launch order, as (query, tables, packed rays, motion
    blur, shadow mode, its output), all copied."""
    from distributionraytracer_tpu_torch.accel import cuda_bvh as CBV

    log = []
    lc, ls = CBV.launch_packet_closest, CBV.launch_packet_shadow

    def closest(tabs, rays, mb, out_f, out_i):
        lc(tabs, rays, mb, out_f, out_i)
        log.append(("closest", tabs, rays.clone(), mb, None,
                    (out_f.clone(), out_i.clone())))

    def shadow(tabs, rays, mb, mode, occ):
        ls(tabs, rays, mb, mode, occ)
        log.append(("shadow", tabs, rays.clone(), mb, mode, occ.clone()))

    CBV.launch_packet_closest, CBV.launch_packet_shadow = closest, shadow
    try:
        render()
        torch.cuda.synchronize()
    finally:
        CBV.launch_packet_closest, CBV.launch_packet_shadow = lc, ls
    return log


def walk_launcher(torch, rec):
    """A bare launch of ``rec``'s walk into fresh outputs, a check of those
    outputs against the recorded ones, and the outputs."""
    from distributionraytracer_tpu_torch.accel import cuda_bvh as CBV
    from distributionraytracer_tpu_torch.ops import build

    lib = build.load().lib

    q, tabs, rays, mb, mode, ref = rec
    n = rays.shape[1]
    walk = CBV.WALKS[tabs.kind]
    if q == "closest":
        out = (torch.empty_like(ref[0]), torch.empty_like(ref[1]))
        args = (int(mb), walk, out[0].data_ptr(), out[1].data_ptr())
        fn = lib.drt_packet_closest
    else:
        out = torch.empty_like(ref)
        args = (int(mb), walk, int(mode == "grid"), out.data_ptr())
        fn = lib.drt_packet_shadow

    def launch():
        err = fn(tabs.nodes.data_ptr(), tabs.n_nodes, tabs.objs.data_ptr(),
                 rays.data_ptr(), n, *args,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"drt_packet_{q}: CUDA error {err} at launch")

    def same():
        """Ids (closest) or occlusion (shadow) equal on every lane, t
        within 1e-5 relative."""
        torch.cuda.synchronize()
        if q == "shadow":
            return bool(torch.equal(out, ref))
        hit = ref[1] >= 0
        rel = ((out[0][0] - ref[0][0]).abs()
               / ref[0][0].abs().clamp(min=1.0))[hit]
        return bool(torch.equal(out[1], ref[1])) and (
            rel.numel() == 0 or float(rel.max()) <= 1e-5)

    return launch, same, out


def walk_rows(torch, card, st):
    """K7 at each launch of the accelerated frame's main path (4 closest,
    5 shadow), held to the plain walk on every lane, beside its live share
    and the plain walk's node and object tests per live lane; the bare
    launches' sums over the frame's K7 launches (main and grid routes) and
    K8's (legacy route); K8 on its row's inputs (the main path's level-1
    closest and primary shadow launches, on K8's tables), each launch held
    to its recorded output.  Returns the sums."""
    from distributionraytracer_tpu_torch.accel.bvh import threaded_walk

    samples = st["samples"]
    frames = {key: record_walks(torch, lambda r=st[key]:
                                r.render_with_samples(samples))
              for key in ("bvh", "grid", "leg")}
    # K8's row: its tables on the main path's level-1 closest and primary
    # shadow launches, its first launch's outputs the reference (accel_rows
    # holds them to the plain walk)
    frames["leg-row"] = []
    for q in ("closest", "shadow"):
        rec = next(r for r in frames["bvh"][:2] if r[0] == q)
        rec = (q, st["leg"].tabs) + rec[2:]
        launch, _, out = walk_launcher(torch, rec)
        launch()
        frames["leg-row"].append(rec[:5] + (
            tuple(x.clone() for x in out) if q == "closest" else out.clone(),))
    times = {}  # frame -> [ms of each launch]
    for key, log in frames.items():
        ms = []
        for rec in log:
            launch, same, _ = walk_launcher(torch, rec)
            launch()
            check(same(), f"{key} route: a {rec[0]} launch differs from "
                  "its recorded output")
            ms.append(timed_ms(torch, launch, 20))
        times[key] = ms
    types = tuple(sorted(set(st["bvh"].scene.static.obj_types)))
    level = {"closest": 1, "shadow": 0}
    for j, rec in enumerate(frames["bvh"]):
        q, tabs, rays, mb, mode, ref = rec
        o, d = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
        valid = rays[7] != 0
        live = int(valid.sum())
        stats = {}
        if q == "closest":
            got = threaded_walk(tabs, o, d, rays[6], valid, motion_blur=mb,
                                types_present=types, stats=stats)[2]
            ok = torch.equal(got, ref[1])
        else:
            got = threaded_walk(tabs, o, d, None, valid,
                                shadow_dist=rays[6], shadow_mode=mode,
                                motion_blur=mb, types_present=types,
                                stats=stats)
            ok = torch.equal(got, ref)
        check(ok, f"K7 {q} at level {level[q]}: lanes differ from the "
              "plain walk")
        per = max(live, 1)
        print(f"K7 {q} level {level[q]}: {rays.shape[1]} lanes, live share "
              f"{live / rays.shape[1]:.4f}, plain walk "
              f"{stats['node_tests'] / per:.1f} node and "
              f"{stats['obj_tests'] / per:.1f} object tests per live lane; "
              f"kernel {times['bvh'][j]:.4f} ms (equal to plain on every "
              f"lane) | {card}")
        level[q] += 1
    for j, q in enumerate(("closest", "shadow")):
        print(f"K8 {q} on the main path's {('level-1', 'primary')[j]} "
              f"inputs (K8's row): {times['leg-row'][j]:.4f} ms | {card}")
    sums = {}
    for key, label in (("bvh", "K7, accelerated main path"),
                       ("grid", "K7, grid route"),
                       ("leg", "K8, legacy route")):
        for q in ("closest", "shadow"):
            idx = [j for j, rec in enumerate(frames[key]) if rec[0] == q]
            sums[key, q] = sum(times[key][j] for j in idx)
            print(f"{label}, {q}: {len(idx)} launches, bare-launch sum "
                  f"{sums[key, q]:.4f} ms | {card}")
    return sums


def frame_sums(wprof, pprof, rows, levels, bounces, card):
    """K3's and the looped K6's summed device time in the profiled frames,
    beside one launch (K3 at level 0, the looped K6 on the breakdown's
    tile) and the per-level and per-bounce times of one tile (K6 there
    one single-bounce launch a bounce)."""
    single = {r["name"]: r["ms"] for r in rows}
    out = {}
    for key, prof, kern, name, per in (
            ("K3", wprof, "whitted_level_kernel", "fused_level", levels),
            ("K6loop", pprof, "pt_bounce_kernel_loop", "pt_bounce_loop",
             bounces)):
        n, ms = kernel_sum(prof, kern)
        tile = sum(x[-1] for x in per)
        print(f"{key} {name} in the profiled frame: {n} launches, "
              f"{ms:.3f} ms summed; one launch "
              f"{single.get(name, per[0][-1]):.4f} ms; one tile's "
              f"levels/bounces {tile:.4f} ms | {card}")
        out[key] = {"frame_launches": n, "frame_ms": ms, "tile_ms": tile,
                    "per_launch": per}
    return out


def walk_frame_sums(aprof, lprof, rows, walk_sums, card):
    """K7's summed device time in the profiled accelerated frame and K8's
    in the profiled legacy-route frame, beside their single-launch times
    (level-1 closest, primary shadow) and the bare launches' sums."""
    single = {r["name"]: r["ms"] for r in rows}
    for prof, walk, key, label in ((aprof, "grouped", "bvh", "accelerated "
                                    "frame"),
                                   (lprof, "legacy", "leg", "legacy-route "
                                    "frame")):
        for q in ("closest", "shadow"):
            n, ms = kernel_sum(prof, f"{walk}_{q}_kernel")
            print(f"{walk}_{q} in the profiled {label}: {n} launches, "
                  f"{ms:.3f} ms summed; one launch "
                  f"{single[walk + '_' + q]:.4f} ms; bare launches summed "
                  f"{walk_sums[key, q]:.4f} ms | {card}")


# ---------------------------------------------------------------------------
# K2 and K5 at each launch of the staged frames
PLAIN_CHUNK = 1 << 16  # lanes a plain any-hit call takes at a time


def record_calls(module, name, run, keep):
    """Runs ``run()`` with ``module.name`` wrapped: returns the arguments,
    by name, and the result of each call whose index ``keep`` accepts, in
    call order, and the number of calls."""
    import inspect
    orig = getattr(module, name)
    sig = inspect.signature(orig)
    log, calls = [], [0]

    def rec(*args, **kw):
        out = orig(*args, **kw)
        if keep(calls[0]):
            b = sig.bind(*args, **kw)
            b.apply_defaults()
            log.append((dict(b.arguments), out))
        calls[0] += 1
        return out

    setattr(module, name, rec)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return log, calls[0]


def any_hit_launch(torch, CI, a):
    """A bare K2 launch on ``a`` (``any_hit``'s arguments by name) into a
    fresh output, and that output; K2 reads the callers' tensors in
    place."""
    tb = a["tables"] if a["tables"] is not None else CI.object_tables(
        a["scene"])
    o, d, dist, ex = a["o"], a["d"], a["max_dist"], a["exclude_obj"]
    occ = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    ex = None if ex is None else ex.to(torch.int32).contiguous()
    return (lambda: CI.launch_any_hit(tb, o, d, dist, ex, a["valid"],
                                      a["mode"], occ)), occ


def pt_any_hit_launch(torch, CP, a):
    """A bare K5 launch on ``a`` (``pt_any_hit``'s arguments by name) into
    a fresh output, and that output."""
    tb = a["tables"] if a["tables"] is not None else CP.pt_tables(a["scene"])
    o = a["o"]
    occ = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    return (lambda: CP.launch_any_hit(tb, o, a["d"], a["time"], a["tmax"],
                                      occ)), occ


def pt_closest_launch(torch, CP, a):
    """A bare K4 launch on ``a`` (``pt_closest``'s arguments by name) into
    fresh outputs, and a function returning them as (hit, t, normal,
    material); K4 reads the callers' tensors in place."""
    tb = a["tables"] if a["tables"] is not None else CP.pt_tables(a["scene"])
    o, d, t = a["o"], a["d"], a["time"].to(torch.float32).contiguous()
    out = CP.closest_outputs(o.shape[0], o.device)
    return ((lambda: CP.launch_closest(tb, o, d, t, out)),
            lambda: (out.hit, out.t, out.normal, out.mat))


def closest_hit_launch(torch, CI, a):
    """A bare K1 launch on ``a`` (``closest_hit``'s arguments by name) into
    fresh outputs, and a function returning them as a HitResult; K1 reads
    the callers' tensors in place."""
    tb = a["tables"] if a["tables"] is not None else CI.object_tables(
        a["scene"])
    valid, mb = a["valid"], a["motion_blur"]
    t = a["time"].to(torch.float32).contiguous()
    valid = None if valid is None else valid.to(torch.bool).contiguous()
    o, d = CI.ray_inputs("closest_hit", a["o"], a["d"], t, valid)
    out = CI.closest_outputs(o.shape[0], o.device)
    return (lambda: CI.launch_closest_hit(tb, o, d, t, valid, mb, out),
            lambda: out)


def binned_closest_launch(torch, CBN, tabs, pb, o, d, t, valid):
    """A bare K9 launch on these inputs into fresh outputs: (launch, a
    function returning its (t, normal, object id), a function returning the
    work list of its last launch)."""
    R = o.shape[0]
    o, d, t, valid = CBN.binned_closest_inputs(o, d, t, valid)
    out = (torch.empty((R,), device=o.device),
           torch.empty((R, 3), device=o.device),
           torch.empty((R,), dtype=torch.int32, device=o.device))
    last = []

    def launch():
        last[:] = [CBN.launch_binned_closest(tabs, pb, o, d, t, valid, False,
                                             *out)]

    return launch, lambda: out, lambda: last[0]


def pt_closest_differing(torch, PT, a, got):
    """Lanes where K4's (hit, t, normal, material) differ from hit_world's
    on the same inputs: hit or material (the winner's) unequal, or, on a
    hit, t beyond rtol 1e-5 or a normal beyond 1e-4 (the card tests'
    tolerances)."""
    hit, t, nrm, mat = got
    ref = PT.hit_world(a["scene"], a["o"], a["d"], a["time"])
    bad = (hit != ref.hit) | (mat != ref.mat)
    bad |= ref.hit & (((t - ref.t).abs() > 1e-5 * ref.t.abs())
                      | ((nrm - ref.normal).abs().amax(-1) > 1e-4))
    return int(bad.sum())


def binned_shadow_launch(torch, CBN, tabs, lb, lid, o, d, dist, valid,
                         mode):
    """A bare K10 launch on these inputs into a fresh output: (launch, its
    output, a function returning the work list of its last launch)."""
    occ = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    o, d, dist, valid, lid = CBN.shadow_inputs(o, d, dist, valid, lid)
    last = []

    def launch():
        last[:] = [CBN.launch_binned_shadow(tabs, lb, lid, o, d, dist, valid,
                                            mode, occ)]

    return launch, occ, lambda: last[0]


def k2_lanes_differing(torch, CI, a, occ):
    """Lanes where K2's ``occ`` differs from its plain versions, as
    (against ``any_hit_brute``, against ``any_hit_runs``): valid lanes against the fold (taken
    PLAIN_CHUNK lanes at a time), invalid lanes against no occluder.
    ``any_hit_runs`` tests in the kernel's operation order, so it must give
    0; ``any_hit_brute``'s triangle test takes torch's cross product, whose
    rounding may move a hit at a triangle's edge."""
    from distributionraytracer_tpu_torch.ops.intersect import any_hit_brute
    valid = a["valid"]
    dead = 0
    if valid is not None:
        dead = int(occ[~valid].sum())
        idx = torch.nonzero(valid)[:, 0]
    else:
        idx = torch.arange(occ.shape[0], device=occ.device)
    tb = a["tables"] if a["tables"] is not None else CI.object_tables(
        a["scene"])
    ex = a["exclude_obj"]
    bad = [dead, dead]
    for s in range(0, idx.shape[0], PLAIN_CHUNK):
        k = idx[s:s + PLAIN_CHUNK]
        dist, exk = a["max_dist"][k], None if ex is None else ex[k]
        ref = any_hit_brute(a["scene"], a["o"][k], a["d"][k],
                            torch.zeros_like(dist), dist, exk,
                            a["motion_blur"], mode=a["mode"])
        bad[0] += int((ref != occ[k]).sum())
        ref = CI.any_hit_runs(tb, a["o"][k], a["d"][k], dist, exk, a["mode"])
        bad[1] += int((ref != occ[k]).sum())
    return tuple(bad)


def k2_verdict(lanes, bad, label):
    """Checks and words K2's lanes differing from its plain versions."""
    brute, runs = bad
    check(brute <= LANE_BUDGET * lanes and runs == 0,
          f"{label}: lanes differing from any_hit_brute {brute}, from its "
          f"run fold {runs}")
    return f"lanes differing {brute} (any_hit_brute), {runs} (its run fold)"


def same_answer(torch, a, occ, ref):
    """Whether a bare launch's ``occ`` is the answer the frame got on the
    lanes it consumes (its valid lanes)."""
    v = a["valid"]
    return bool(torch.equal(occ, ref) if v is None
                else torch.equal(occ[v], ref[v]))


def staged_breakdown(torch, card, scene, cfg, samples, pts, pcfg, paths,
                     pt_frame, cost):
    """K2 at each launch of the Whitted staged route's middle tile and of
    one cost-brute frame of each mode, K4 and K5 at each launch of the PT
    staged body's middle tile: bare launch times on the recorded inputs,
    each launch held to its plain version on every lane.  ``cost`` maps a mode
    to its cost-brute renderer and SampleSet.  Returns the per-launch
    rows."""
    from distributionraytracer_tpu_torch.integrator import pathtracer as PT
    from distributionraytracer_tpu_torch.integrator.render import (
        render_from_samples,
    )
    from distributionraytracer_tpu_torch.integrator.whitted import (
        brute_intersectors,
    )
    from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
    from distributionraytracer_tpu_torch.ops import cuda_pt as CP

    out = {"K2": [], "K2cost": {}, "K4": [], "K5": []}
    # ---- K2, the Whitted staged route's middle tile ----
    H, W, S = samples.time.shape
    tiles = -(-(H * W * S) // cfg.tile_rays)
    levels = cfg.max_depth + 1
    k = tiles // 2
    log, calls = record_calls(
        CI, "any_hit", lambda: render_from_samples(
            scene, cfg, samples, inter=brute_intersectors(scene, cfg)),
        lambda j: j // levels == k)
    check(calls == tiles * levels and len(log) == levels,
          f"K2 breakdown: {calls} calls, {len(log)} on tile {k}")
    for lv, (a, ref) in enumerate(log):
        launch, occ = any_hit_launch(torch, CI, a)
        launch()
        n = occ.shape[0]
        check(same_answer(torch, a, occ, ref), f"K2 level {lv}: the bare "
              "launch differs from the frame's")
        verdict = k2_verdict(n, k2_lanes_differing(torch, CI, a, occ),
                             f"K2 level {lv}")
        ms = timed_ms(torch, launch, 20)
        share = 1.0 if a["valid"] is None else float(a["valid"].float().mean())
        print(f"K2 level {lv} (Whitted staged route, tile {k}): {n} lanes, "
              f"valid {share:.4f}, mode {a['mode']}: {ms:.4f} ms; vs plain: "
              f"{verdict} | {card}")
        out["K2"].append((n, share, ms))
    print(f"K2, one tile's levels: {sum(x[-1] for x in out['K2']):.4f} ms "
          f"| {card}")
    # ---- K2, one cost-brute frame of each mode ----
    for mode, (r, smp) in cost.items():
        log, calls = record_calls(
            CI, "any_hit", lambda r=r, smp=smp: r.render_with_samples(smp),
            lambda j: True)
        tot, ms_sum, lanes = [0, 0], 0.0, 0
        for a, ref in log:
            launch, occ = any_hit_launch(torch, CI, a)
            launch()
            check(a["mode"] == mode and same_answer(torch, a, occ, ref),
                  f"cost-brute {mode}: a bare launch differs from the "
                  "frame's")
            bad = k2_lanes_differing(torch, CI, a, occ)
            ms_sum += timed_ms(torch, launch, 20)
            tot = [x + y for x, y in zip(tot, bad)]
            lanes += occ.shape[0]
        verdict = k2_verdict(lanes, tot, f"cost-brute {mode}")
        print(f"K2 cost-brute frame, mode {mode}: {calls} launches, {lanes} "
              f"lanes, bare-launch sum {ms_sum:.4f} ms; vs plain: {verdict} "
              f"| {card}")
        out["K2cost"][mode] = (calls, ms_sum)
    # ---- K4 and K5, the PT staged body's middle tile ----
    B, n_pl = pcfg.max_bounces, pts.plight_pos.shape[0]
    ptiles = -(-paths // pcfg.pt_tile_rays)
    k = ptiles // 2
    shadow = []

    def pt_frame_staged():
        log5, n5 = record_calls(
            CP, "pt_any_hit", lambda: pt_frame(PT.kernel_queries(pts)),
            lambda j: j // (B * n_pl) == k)
        check(n5 == ptiles * B * n_pl, f"K5 breakdown: {n5} calls")
        shadow.extend(log5)

    # K4's calls give each bounce's hits; a lane the staged body has ended
    # keeps its ray, so a lane is live at bounce b >= 1 where its ray moved
    hits, n4 = record_calls(CP, "pt_closest", pt_frame_staged,
                            lambda j: j // B == k)
    check(n4 == ptiles * B and len(hits) == B and len(shadow) == B * n_pl,
          f"K5 breakdown: {len(hits)} closest and {len(shadow)} shadow calls "
          f"on tile {k}")
    alive = None
    for b in range(B):
        a_c, h = hits[b]
        if b == 0:
            alive = torch.ones_like(h.hit)
        else:
            prev = hits[b - 1][0]
            alive = ((a_c["o"] != prev["o"]).any(-1)
                     | (a_c["d"] != prev["d"]).any(-1))
        launch4, got4 = pt_closest_launch(torch, CP, a_c)
        launch4()
        g4 = got4()
        check(torch.equal(g4[0], h.hit) and torch.equal(g4[3], h.mat),
              f"K4 bounce {b}: the bare launch differs from the frame's")
        bad4 = pt_closest_differing(torch, PT, a_c, g4)
        check(bad4 == 0, f"K4 bounce {b}: {bad4} lanes differ from hit_world")
        ms4 = timed_ms(torch, launch4, 20)
        share4 = float(alive.float().mean())
        print(f"K4 bounce {b} (PT staged body, tile {k}): {h.hit.shape[0]} "
              f"lanes, live {share4:.4f}: {ms4:.4f} ms; vs hit_world: lanes "
              f"differing {bad4} | {card}")
        out["K4"].append((b, share4, ms4))
        live = alive & h.hit
        for j in range(n_pl):
            a, ref = shadow[b * n_pl + j]
            launch, occ = pt_any_hit_launch(torch, CP, a)
            launch()
            plain = PT.any_hit(a["scene"], a["o"], a["d"], a["time"], 1e-3,
                               a["tmax"])
            bad = int((plain != occ).sum())
            check(bad == 0 and torch.equal(occ, ref),
                  f"K5 bounce {b} light {j}: {bad} lanes differ from plain")
            ms = timed_ms(torch, launch, 20)
            share = float(live.float().mean())
            print(f"K5 bounce {b} light {j} (PT staged body, tile {k}): "
                  f"{occ.shape[0]} lanes, live {share:.4f}: {ms:.4f} ms; vs "
                  f"plain: lanes differing {bad} | {card}")
            out["K5"].append((b, j, share, ms))
    print(f"K4, one tile's bounces: {sum(x[-1] for x in out['K4']):.4f} "
          f"ms | {card}")
    print(f"K5, one tile's bounces and lights: "
          f"{sum(x[-1] for x in out['K5']):.4f} ms | {card}")
    return out


def k1_lanes_differing(torch, CI, a, h):
    """Lanes where K1's HitResult ``h`` differs from its plain versions, as
    (against ``closest_hit_brute``: hit, object or material id on a valid
    lane, or t or normal beyond 1e-4 + 1e-4 |x| where the ids agree;
    against ``closest_hit_runs``: object id or t unequal; a lane that is
    not valid against a miss).
    Valid lanes are taken PLAIN_CHUNK at a time.  ``closest_hit_runs``
    tests in the kernel's operation order, so it must give 0."""
    from distributionraytracer_tpu_torch.ops.intersect import (
        closest_hit_brute,
    )
    valid = a["valid"]
    dead = 0
    if valid is not None:
        dead = int((h.hit[~valid] | (h.obj_id[~valid] != -1)).sum())
        idx = torch.nonzero(valid)[:, 0]
    else:
        idx = torch.arange(h.t.shape[0], device=h.t.device)
    tb = a["tables"] if a["tables"] is not None else CI.object_tables(
        a["scene"])
    sc, mb = a["scene"], a["motion_blur"]
    near = lambda x, y: (x - y).abs() <= 1e-4 + 1e-4 * y.abs()
    bad = [dead, dead]
    for s in range(0, idx.shape[0], PLAIN_CHUNK):
        k = idx[s:s + PLAIN_CHUNK]
        o, d, t = a["o"][k], a["d"][k], a["time"][k]
        ref = closest_hit_brute(sc, o, d, t, mb)
        ids = ((ref.hit != h.hit[k]) | (ref.obj_id != h.obj_id[k])
               | (ref.hit & (ref.mat_id != h.mat_id[k])))
        off = ref.hit & ~ids & ~(near(h.t[k], ref.t)
                                 & near(h.normal[k], ref.normal).all(-1))
        bad[0] += int((ids | off).sum())
        rt, rid = CI.closest_hit_runs(tb, o, d, t, mb)
        bad[1] += int(((rid != h.obj_id[k]) | (rt != h.t[k])).sum())
    return tuple(bad)


def k1_held(torch, CI, a, ref, label):
    """A bare K1 launch on a recorded call's arguments ``a``, held to the
    object ids the frame got (``ref``) on its valid lanes: (launch, its
    HitResult, its lanes differing from the plain versions, as
    :func:`k1_lanes_differing` counts them)."""
    launch, got = closest_hit_launch(torch, CI, a)
    launch()
    h = got()
    v = a["valid"]
    same = (torch.equal(h.obj_id, ref.obj_id) if v is None
            else torch.equal(h.obj_id[v], ref.obj_id[v]))
    check(same, f"{label}: the bare launch differs from the frame's")
    return launch, h, k1_lanes_differing(torch, CI, a, h)


def k1_verdict(lanes, bad, label):
    """Checks and words K1's lanes differing from its plain versions."""
    brute, runs = bad
    check(brute <= LANE_BUDGET * lanes and runs == 0,
          f"{label}: lanes differing from closest_hit_brute {brute}, from "
          f"its run fold {runs}")
    return (f"lanes differing {brute} (closest_hit_brute), {runs} (its run "
            "fold)")


def k1_breakdown(torch, card, scene, cfg, samples, cost, count, add_row,
                 errs, w_ops):
    """K1 at each launch of the Whitted staged route's middle tile and of
    one cost-brute frame of each mode (``cost`` maps a mode to its
    cost-brute renderer and SampleSet): bare launch times on the recorded
    inputs, each launch held to its plain versions on every lane.  Then
    the kernels' row of K1 at the cost-brute shape: the first launch of
    the BVH mode's frame (a tile's primary rays, 1,005 objects), with
    ``count`` launches a frame, its bound's operations from ``w_ops``
    (scene, HitResult, inputs) and its max abs err against
    ``closest_hit_brute`` into ``errs``.  Returns the per-level rows."""
    from distributionraytracer_tpu_torch.integrator.render import (
        render_from_samples,
    )
    from distributionraytracer_tpu_torch.integrator.whitted import (
        brute_intersectors,
    )
    from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
    from distributionraytracer_tpu_torch.ops.intersect import (
        closest_hit_brute,
    )

    out = []
    H, W, S = samples.time.shape
    tiles = -(-(H * W * S) // cfg.tile_rays)
    levels = cfg.max_depth + 1
    k = tiles // 2
    log, calls = record_calls(
        CI, "closest_hit", lambda: render_from_samples(
            scene, cfg, samples, inter=brute_intersectors(scene, cfg)),
        lambda j: j // levels == k)
    check(calls == tiles * levels and len(log) == levels,
          f"K1 breakdown: {calls} calls, {len(log)} on tile {k}")
    for lv, (a, ref) in enumerate(log):
        launch, h, bad = k1_held(torch, CI, a, ref, f"K1 level {lv}")
        n = h.t.shape[0]
        verdict = k1_verdict(n, bad, f"K1 level {lv}")
        ms = timed_ms(torch, launch, 20)
        share = 1.0 if a["valid"] is None else float(a["valid"].float().mean())
        print(f"K1 level {lv} (Whitted staged route, tile {k}): {n} lanes, "
              f"valid {share:.4f}: {ms:.4f} ms; vs plain: {verdict} | {card}")
        out.append((n, share, ms))
    print(f"K1, one tile's levels: {sum(x[-1] for x in out):.4f} ms | {card}")
    first = None
    for mode, (r, smp) in cost.items():
        log, calls = record_calls(
            CI, "closest_hit", lambda r=r, smp=smp: r.render_with_samples(smp),
            lambda j: True)
        tot, ms_sum, lanes = [0, 0], 0.0, 0
        for j, (a, ref) in enumerate(log):
            launch, h, bad = k1_held(torch, CI, a, ref,
                                     f"K1 cost-brute {mode} launch {j}")
            ms_sum += timed_ms(torch, launch, 20)
            tot = [x + y for x, y in zip(tot, bad)]
            lanes += h.t.shape[0]
            if first is None:
                first = (a, launch, h)
        verdict = k1_verdict(lanes, tot, f"K1 cost-brute {mode}")
        print(f"K1 cost-brute frame, mode {mode}: {calls} launches, {lanes} "
              f"lanes, bare-launch sum {ms_sum:.4f} ms; vs plain: {verdict} "
              f"| {card}")
    a, launch, h = first
    sc, o, d, t, mb = a["scene"], a["o"], a["d"], a["time"], a["motion_blur"]
    tb = a["tables"] if a["tables"] is not None else CI.object_tables(sc)
    n, n_obj = o.shape[0], sc.static.n_objects
    check(a["valid"] is None or bool(a["valid"].all()),
          "K1 cost-brute row: the first launch has invalid lanes")
    ref = closest_hit_brute(sc, o, d, t, mb)
    same = ref.hit & (ref.obj_id == h.obj_id)
    errs["K1c"] = max(float((h.t - ref.t)[same].abs().max()),
                      float((h.normal - ref.normal)[same].abs().max()))
    add_row("K1c", count, "cost-brute route frame", n, launch,
            lambda: CI.closest_hit_kernel(sc, o, d, t, mb, tables=tb),
            lambda: closest_hit_brute(sc, o, d, t, mb),
            n * (4 * (7 + 1 + 3 + 2) + 1) + 4 * tb.runs.numel()
            + n_obj * 4 * 16, w_ops(sc, h, o, d, t, mb),
            f"{n} primary rays of a tile, {n_obj} objects")
    return out


def staged_profiles(torch, card, scene, cfg, samples, pt_frame, pts,
                    frames=2):
    """Warm frames of the two staged routes, then one more of each under
    torch.profiler with K1's, K2's and K5's wrappers in record_function
    ranges: device-busy ms, idle share, the frame sums of K1 and K2
    (Whitted staged) and K4 and K5 (PT staged), and the copies the
    wrappers launch."""
    from torch.profiler import record_function

    from distributionraytracer_tpu_torch.integrator import pathtracer as PT
    from distributionraytracer_tpu_torch.integrator.render import (
        render_from_samples,
    )
    from distributionraytracer_tpu_torch.integrator.whitted import (
        brute_intersectors,
    )
    from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
    from distributionraytracer_tpu_torch.ops import cuda_pt as CP

    routes = (
        ("Whitted staged route", lambda: render_from_samples(
            scene, cfg, samples, inter=brute_intersectors(scene, cfg)),
         CI, (("closest_hit_kernel", "K1 wrapper"),
              ("any_hit_kernel", "K2 wrapper")),
         (("K1", "closest_hit_kernel"), ("K2", "any_hit_kernel"))),
        ("PT staged body", lambda: pt_frame(PT.kernel_queries(pts)),
         CP, (("pt_any_hit_kernel", "K5 wrapper"),),
         (("K4", "pt_closest_kernel"), ("K5", "pt_any_hit_kernel"))))
    out = {}
    for label, render, mod, wrappers, kernels in routes:
        times = []
        for _ in range(frames):
            t0 = time.perf_counter()
            render()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        print(f"{label}: {frames} warm frames "
              f"{' '.join(f'{x:.4f}' for x in times)} s (median {med:.4f}) "
              f"| {card}")
        origs = {w: getattr(mod, w) for w, _ in wrappers}
        for wrapper, scope in wrappers:
            def scoped(*args, orig=origs[wrapper], scope=scope, **kw):
                with record_function(scope):
                    return orig(*args, **kw)

            setattr(mod, wrapper, scoped)
        try:
            prof, copies, busy = profile_frame(
                torch, render, med, label,
                scopes=tuple(sc for _, sc in wrappers))
        finally:
            for wrapper, orig in origs.items():
                setattr(mod, wrapper, orig)
        sums = {}
        for key, kern in kernels:
            # "any_hit_kernel" is also the tail of "pt_any_hit_kernel"
            hit = [v for name, v in prof.items() if kern in name
                   and not (kern == "any_hit_kernel" and "pt_" + kern in name)]
            sums[key] = (sum(n for n, _ in hit), sum(ms for _, ms in hit))
            print(f"{key} ({kern}) in the profiled {label} frame: "
                  f"{sums[key][0]} launches, {sums[key][1]:.3f} ms summed | "
                  f"{card}")
        copies_ms = {}
        for wrapper, scope in wrappers:
            cp = copies.get(scope, {})
            copies_ms[scope] = sum(ms for _, ms in cp.values())
            print(f"{label}: copies launched inside {wrapper}'s wrapper: "
                  f"{sum(n for n, _ in cp.values())} kernels, "
                  f"{copies_ms[scope]:.3f} ms | {card}")
        out[label] = {"median": med, "busy_ms": busy, "sums": sums,
                      "copies_ms": copies_ms}
    return out


# ---------------------------------------------------------------------------
# Slice C1: gradients (the differentiable K1/K2 route)
GRAD_STEPS = 3  # SGD steps of the gradient phase
GRAD_STEP = 0.05  # the first step's largest change of a colour channel
GRAD_CHECK_ROWS = 4  # rows of the sub-band held against plain autodiff


def sgd_steps(torch, counted, loss_of, start, label, expect):
    """GRAD_STEPS projected SGD steps in ``mat_cd`` from ``start``: each
    step's loss and gradient (``loss_of({"mat_cd": x})``) between a reset
    and a read of the launch counters (``expect``), then a step of a fixed
    rate, GRAD_STEP over the first gradient's largest element.  Returns
    the losses, step and forward seconds, launch counts, the peak device
    memory in GiB, the rate and the last iterate."""
    x, rate, peak = start, None, 0.0
    losses, step_s, fwd_s, runs = [], [], [], []
    for i in range(GRAD_STEPS + 1):
        x = x.detach().requires_grad_(True)

        def step(x=x):
            t0 = time.perf_counter()
            loss = loss_of({"mat_cd": x})
            torch.cuda.synchronize()
            fwd = time.perf_counter() - t0
            (g,) = torch.autograd.grad(loss, x)
            return float(loss.detach()), g, fwd

        torch.cuda.reset_peak_memory_stats()
        (loss, g, fwd), got, secs = counted(label.format(i=i), step, expect)
        peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
              f"step {i}: gradient not finite or all zero")
        losses.append(loss)
        step_s.append(secs)
        fwd_s.append(fwd)
        runs.append(got)
        if i < GRAD_STEPS:
            if rate is None:
                rate = GRAD_STEP / float(g.abs().max())
            x = torch.clamp(x.detach() - rate * g, 0.0, 1.0)
    return losses, step_s, fwd_s, runs, peak, rate, x


def held_gradients(torch, counted, loss_of, leaves, routes):
    """The loss and its gradients in ``leaves`` (name: start value) on each
    of two ``routes`` (label, route config, expected launches), each
    between a reset and a read of the launch counters; returns the
    relative loss difference and each gradient's largest difference over
    the second route's largest element."""
    got = []
    for label, route_cfg, expect in routes:
        xs = {n: v.clone().requires_grad_(True) for n, v in leaves.items()}

        def run(xs=xs, route_cfg=route_cfg):
            loss = loss_of(xs, route_cfg)
            return (float(loss.detach()),
                    torch.autograd.grad(loss, list(xs.values())))
        got.append(counted(label, run, expect)[0])
    (lk, gk), (lp, gp) = got
    return lk, lp, abs(lk - lp) / lp, [
        float((u - v).abs().max() / v.abs().max()) for u, v in zip(gk, gp)]


def grad_phase(torch, card, counted, scene, cfg, samples):
    """Phase 9: inverse-rendering steps on the main path's scene.

    The band of SLAB rows (32 rows of 800 at 16 spp, 409,600 samples):
    the target is its render under no_grad on the default K3 route; the
    start is every material colour 0.1 brighter (clamped to [0, 1]); each
    step takes ``l2_render_loss`` through ``accel_intersectors(...,
    differentiable=True)`` (K1 and K2 under no_grad, the hits recomputed in
    torch) and its gradient in ``mat_cd``, and a projected SGD step of a
    fixed rate (GRAD_STEP over the first gradient's largest element)
    follows.  The band bounds the autograd graph, which every tile of the
    loss keeps alive until the backward."""
    import dataclasses

    from distributionraytracer_tpu_torch.integrator.render import (
        render_from_samples,
    )
    from distributionraytracer_tpu_torch.parallel.mesh import (
        accel_intersectors, l2_render_loss,
    )

    a, b = SLAB
    band = samples.rows(a, b)
    with torch.no_grad():
        target, nrays = render_from_samples(scene, cfg, band, row_offset=a,
                                            return_rays=True)
    start = torch.clamp(scene.mat_cd + 0.1, 0.0, 1.0)

    def loss_of(leaves, rows, route_cfg, diff):
        sc = dataclasses.replace(scene, **leaves)
        inter = (accel_intersectors(sc, route_cfg, None, differentiable=True)
                 if diff else None)
        return l2_render_loss(sc, route_cfg, samples.rows(a, a + rows),
                              target[:rows], row_offset=a, inter=inter)

    # the default route refuses a leaf that requires a gradient
    refused = None
    try:
        loss_of({"mat_cd": start.clone().requires_grad_(True)}, 1, cfg, False)
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "forward-only" in refused,
          f"the K3 route took a leaf that requires a gradient ({refused})")
    print(f"gradient through the default route (K3) refused: {refused}")

    losses, step_s, fwd_s, _, peak, rate, x = sgd_steps(
        torch, counted, lambda lv: loss_of(lv, b - a, cfg, True), start,
        "gradient step {i} (loss and its gradient in mat_cd, "
        "accel_intersectors(differentiable=True))", {"K1": True, "K2": True})
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    med, fmed = statistics.median(step_s[1:]), statistics.median(fwd_s[1:])
    print(f"gradient steps on rows {a}:{b} of 800x600 spp16 depth 4 "
          f"({b - a} rows, {band.time.numel()} samples): loss "
          + " -> ".join(f"{v:.6e}" for v in losses)
          + f" (rate {rate:.4e}); seconds a step (forward + backward) "
          + " ".join(f"{s:.4f}" for s in step_s)
          + f", median after the first {med:.4f} (forward {fmed:.4f}); "
          f"{int(nrays)} rays a forward (the K3 render's count of the "
          f"band), {int(nrays) / fmed:.4e} rays/s; peak "
          f"{peak:.2f} GiB | {card}")

    prof = profile_frame(torch, lambda: loss_of(
        {"mat_cd": x.detach().requires_grad_(True)}, b - a, cfg,
        True).backward(), med, "gradient step")
    for name in ("closest_hit_kernel", "any_hit_kernel"):
        n, ms = kernel_sum(prof, name)
        print(f"{name} in the profiled gradient step: {n} launches, "
              f"{ms:.3f} ms summed | {card}")

    # the K1/K2 route held against plain autodiff on a sub-band
    rows = f"gradient of rows {a}:{a + GRAD_CHECK_ROWS}"
    lk, lp, rel, errs = held_gradients(
        torch, counted, lambda lv, rc: loss_of(lv, GRAD_CHECK_ROWS, rc,
                                               rc.kernels != "off"),
        {"mat_cd": start, "sph_center": scene.sph_center},
        ((f"{rows}, K1/K2 route", cfg, {"K1": True, "K2": True}),
         (f"{rows}, plain route", cfg.replace(kernels="off"), {})))
    check(rel <= 1e-4 and max(errs) <= 1e-3,
          f"K1/K2 gradient route vs plain: loss rel {rel:.3e}, gradient "
          f"errors {errs}")
    print(f"gradient rows {a}:{a + GRAD_CHECK_ROWS} K1/K2 route vs plain "
          f"autodiff: loss {lk:.6e} vs {lp:.6e} (rel {rel:.3e}); largest "
          f"gradient difference over the largest |element|: mat_cd "
          f"{errs[0]:.3e}, sph_center {errs[1]:.3e}  PASS")


# The grid frame's gradient band: rows 0:32, at row offset 0, so that a
# world-size-1 sharded step (phase 10), which renders its rows from offset
# 0, takes the same loss as this phase's step 0.
GRID_BAND = (0, 32)
# The DDA's objects an iteration on the grid frame.  The K the JAX
# package's rule picks (_pick_unroll) is 1 there: the radius-1000 ground
# sphere's box puts every cell in its CSR lists, and the cell around the
# origin holds all 100,005 objects, so each lane tests all of them one an
# iteration.  K sets the work an iteration does, not the answer.
DDA_UNROLL = 256
ID_BUDGET = 0.02  # the grid emulation's tie budget (accel/cuda_grid.py)


def grid_grad_phase(torch, card, counted, acc):
    """Phase 9, grid half: inverse-rendering steps on the accelerated grid
    frame (``mesh_scene``, 100,000 triangles, 512x512, spp 0, depth 4),
    its band of GRID_BAND rows (16,384 samples).  The target is the band's
    render through the emulation tables under no_grad; the start has every
    material colour 0.1 brighter; each step takes ``l2_render_loss`` through
    ``accel_intersectors(CudaGrid, differentiable=True)`` (K7 in grid shadow
    mode under no_grad, the hits recomputed in torch) and its gradient in
    ``mat_cd``, then a projected SGD step.  Then the K7 route against its
    plain walk (``kernels='off'``) on 4 rows, one step through the DDA
    (``accel_intersectors(GridArrays)``, plain torch, no kernel), and the
    DDA's primary object ids against the emulation's.  Returns what phase
    10 holds its sharded step to."""
    import dataclasses

    from distributionraytracer_tpu_torch.accel.cuda_grid import (
        make_cuda_grid_intersectors,
    )
    from distributionraytracer_tpu_torch.accel.grid import (
        make_grid_intersectors,
    )
    from distributionraytracer_tpu_torch.integrator.render import (
        _rays_from_samples, render_from_samples,
    )
    from distributionraytracer_tpu_torch.parallel.mesh import (
        accel_intersectors, l2_render_loss,
    )

    r, cfg, samples = acc["grid"], acc["cfg"], acc["samples"]
    scene, tabs, host = r.scene, r.tabs, r.accel_build.host
    a, b = GRID_BAND
    band = samples.rows(a, b)
    with torch.no_grad():
        target = render_from_samples(
            scene, cfg, band, row_offset=a,
            inter=accel_intersectors(scene, cfg, tabs))
    start = torch.clamp(scene.mat_cd + 0.1, 0.0, 1.0)

    def loss_of(leaves, rows, route_cfg, tables, unroll=None):
        sc = dataclasses.replace(scene, **leaves)
        inter = accel_intersectors(sc, route_cfg, tables, unroll,
                                   differentiable=True)
        return l2_render_loss(sc, route_cfg, samples.rows(a, a + rows),
                              target[:rows], row_offset=a, inter=inter)

    losses, step_s, fwd_s, runs, peak, rate, x = sgd_steps(
        torch, counted, lambda lv: loss_of(lv, b - a, cfg, tabs), start,
        "grid gradient step {i} (loss and its gradient in mat_cd, "
        "accel_intersectors(CudaGrid, differentiable=True))", {"K7": True})
    k7 = [got["K7"] for got in runs]
    check(all(v < u for u, v in zip(losses, losses[1:])),
          f"the grid loss did not fall at every step: {losses}")
    med, fmed = statistics.median(step_s[1:]), statistics.median(fwd_s[1:])
    print(f"grid gradient steps on rows {a}:{b} of the 512x512 100k-triangle "
          f"grid frame ({band.time.numel()} samples): loss "
          + " -> ".join(f"{v:.6e}" for v in losses)
          + f" (rate {rate:.4e}); seconds a step (forward + backward) "
          + " ".join(f"{s:.4f}" for s in step_s)
          + f", median after the first {med:.4f} (forward {fmed:.4f}); K7 "
          f"launches a step {k7}; peak {peak:.2f} GiB | {card}")
    prof = profile_frame(torch, lambda: loss_of(
        {"mat_cd": x.detach().requires_grad_(True)}, b - a, cfg,
        tabs).backward(), med, "grid gradient step")
    sums = [kernel_sum(prof, k) for k in ("grouped_closest_kernel",
                                          "grouped_shadow_kernel")]
    print(f"K7 in the profiled grid gradient step: "
          f"{sum(n for n, _ in sums)} launches, "
          f"{sum(ms for _, ms in sums):.3f} ms summed (closest "
          f"{sums[0][1]:.3f}, shadow {sums[1][1]:.3f}); K3 0 | {card}")

    # the K7 route held against its plain walk on a sub-band
    rows = f"grid gradient of rows {a}:{a + GRAD_CHECK_ROWS}"
    lk, lp, rel, errs = held_gradients(
        torch, counted, lambda lv, rc: loss_of(lv, GRAD_CHECK_ROWS, rc,
                                               tabs),
        {"mat_cd": start, "sph_center": scene.sph_center},
        ((f"{rows}, K7 route", cfg, {"K7": True}),
         (f"{rows}, plain walk route", cfg.replace(kernels="off"), {})))
    check(rel <= 1e-4 and max(errs) <= 1e-3,
          f"K7 grid gradient route vs its plain walk: loss rel {rel:.3e}, "
          f"gradient errors {errs}")
    print(f"grid gradient rows {a}:{a + GRAD_CHECK_ROWS} K7 route vs its "
          f"plain walk: loss {lk:.6e} vs {lp:.6e} (rel {rel:.3e}); largest "
          f"gradient difference over the largest |element|: mat_cd "
          f"{errs[0]:.3e}, sph_center {errs[1]:.3e}  PASS")

    # the DDA route: plain torch on the card, no kernel
    xd = start.clone().requires_grad_(True)

    def dda_step():
        loss = loss_of({"mat_cd": xd}, b - a, cfg, host, DDA_UNROLL)
        (g,) = torch.autograd.grad(loss, xd)
        return float(loss.detach()), g
    torch.cuda.reset_peak_memory_stats()
    (dloss, dg), _, dsecs = counted(
        f"grid gradient step through the DDA (accel_intersectors("
        f"GridArrays, grid_unroll={DDA_UNROLL}), the accel_backend="
        f"'traversal' route), rows {a}:{b}", dda_step, {})
    check(bool(torch.isfinite(dg).all()), "DDA step: gradient not finite")
    print(f"DDA gradient step on rows {a}:{b}: {dsecs:.4f} s (K7 step 0 "
          f"{step_s[0]:.4f} s), loss {dloss:.6e} vs the K7 route's "
          f"{losses[0]:.6e} (rel {abs(dloss - losses[0]) / losses[0]:.3e}), "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
          f"{card}")
    o, d, t, _ = _rays_from_samples(scene, cfg, band, row_offset=a)
    with torch.no_grad():
        he = make_cuda_grid_intersectors(scene, tabs).closest(o, d, t)
        hd = make_grid_intersectors(scene, host,
                                    unroll=DDA_UNROLL).closest(o, d, t)
    share = float((he.obj_id != hd.obj_id).float().mean())
    check(share < ID_BUDGET, f"DDA vs emulation: {share:.4%} of primary "
          "object ids differ")
    print(f"DDA vs the emulation (K7) on the band's {o.shape[0]} primary "
          f"rays: {share:.4%} of object ids differ (budget "
          f"{ID_BUDGET:.0%}), hits {float(hd.hit.float().mean()):.4f}  PASS")
    return dict(loss0=losses[0], rate=rate, start=start, band=band,
                target=target, step0_s=step_s[0])


def sharded_phase(torch, card, counted, whitted, acc, grid):
    """Phase 10: the row sharding at world size 1 on NCCL, its group made
    from a ``file://`` store in a temporary directory (no fallback to
    gloo).  ``whitted``: (renderer, config, SampleSet, image, K3 launches)
    of phase 4's main path; ``acc``: phase 5b's; ``grid``: phase 9's grid
    band."""
    import dataclasses
    import shutil
    import tempfile

    import torch.distributed as dist

    from distributionraytracer_tpu_torch.integrator.render import (
        TileGraphs, render_from_samples,
    )
    from distributionraytracer_tpu_torch.parallel.mesh import (
        accel_intersectors, init_file_group, make_row_mesh,
        make_sharded_train_step, render_image_sharded,
    )

    store = tempfile.mkdtemp(prefix="chip_smoke_group_")
    t0 = time.perf_counter()
    init_file_group("cuda", os.path.join(store, "store"))
    try:
        mesh = make_row_mesh("cuda")
        check(mesh.world == 1 and dist.get_backend() == "nccl",
              f"group {mesh}, backend {dist.get_backend()}")
        # NCCL makes its communicator at the first collective
        dist.all_reduce(torch.zeros(1, device=mesh.device))
        torch.cuda.synchronize()
        print(f"process group: world size {mesh.world}, backend "
              f"{dist.get_backend()}, {mesh.device}, "
              f"{time.perf_counter() - t0:.2f}s to start (its first "
              "all_reduce included)")
        r, cfg, samples, ref, k3 = whitted
        graphs = TileGraphs()

        def sharded():
            return render_image_sharded(r.scene, cfg, mesh, samples=samples,
                                        graphs=graphs)

        img, runs, secs = counted(
            "render_image_sharded, Whitted frame 800x600 spp16 (world size "
            "1, NCCL)", sharded, {"K3": True})
        diff = float((img - ref).abs().max())
        sprof = profile_frame(torch, sharded, secs, "sharded Whitted frame")
        got = kernel_sum(sprof, "whitted_level_kernel")[0]
        check(got == k3 and diff == 0.0,
              f"sharded Whitted frame: {got} K3 kernels in a warm frame's "
              f"device trace (main path {k3}), max difference {diff}")
        print(f"sharded Whitted frame: {got} K3 launches a warm frame in its "
              f"device trace (the main path's {k3}), max difference to "
              f"Renderer.render_with_samples {diff:.1e}, {secs:.4f} s  PASS")

        g, gcfg, gsamples = acc["grid"], acc["cfg"], acc["samples"]
        gimg, _, gsecs = counted(
            "render_image_sharded, grid frame 512x512 on CudaGrid tables "
            "(world size 1, NCCL)", lambda: render_image_sharded(
                g.scene, gcfg, mesh, samples=gsamples, accel=g.tabs),
            {"K7": True})
        single = render_from_samples(
            g.scene, gcfg, gsamples,
            inter=accel_intersectors(g.scene, gcfg, g.tabs))
        gdiff = float((gimg - single).abs().max())
        rdiff = (gimg - acc["img_g"]).abs()
        out = float((rdiff > 3e-3).float().mean())
        check(gdiff == 0.0 and out <= 0.005 and float(rdiff.max()) <= 0.05,
              f"sharded grid frame: {gdiff} against the single process, "
              f"{out:.4%} beyond 3e-3 against the Renderer")
        print(f"sharded grid frame: max difference {gdiff:.1e} to "
              f"render_from_samples(inter=accel_intersectors(CudaGrid)); "
              f"against the Renderer's route (K9 + K7, block-permuted "
              f"tiles) {out:.4%} of elements beyond 3e-3, max diff "
              f"{float(rdiff.max()):.4f}; {gsecs:.4f} s  PASS")

        rows = grid["band"].time.shape[0]
        step = make_sharded_train_step(gcfg, mesh, rows, lr=grid["rate"],
                                       update_leaves=("mat_cd",),
                                       accel=g.tabs)
        (loss, _), _, ssecs = counted(
            "make_sharded_train_step, the grid band (world size 1, NCCL)",
            lambda: step(dataclasses.replace(g.scene, mat_cd=grid["start"]),
                         grid["band"], grid["target"]), {"K7": True})
        rel = abs(float(loss) - grid["loss0"]) / grid["loss0"]
        check(rel <= 1e-6, f"sharded step loss {float(loss)} vs phase 9's "
              f"step 0 {grid['loss0']} (rel {rel:.3e})")
        buf = torch.zeros(1 + g.scene.mat_cd.numel(), device=mesh.device)
        ar_ms = timed_ms(torch, lambda: dist.all_reduce(buf), 20)
        print(f"sharded grid step: loss {float(loss):.6e} vs phase 9's step "
              f"0 {grid['loss0']:.6e} (rel {rel:.1e}), {ssecs:.4f} s "
              f"(phase 9's step 0 {grid['step0_s']:.4f} s); all_reduce of "
              f"its {buf.numel()} floats {ar_ms:.4f} ms (CUDA events, 20 "
              f"calls) | {card}  PASS")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


# ---------------------------------------------------------------------------
# Slice E2: the browser viewer, served on 127.0.0.1 and fetched over HTTP
VIEWER_FRAMES = 5  # progressive /frame requests at one camera


def http_get(port, path):
    """(status, body, headers, seconds) of one GET on 127.0.0.1; an HTTP
    error's status is returned, not raised."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=300) as r:
            status, body, hdrs = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        status, body, hdrs = e.code, b"", {}
    return status, body, hdrs, time.perf_counter() - t0


def spread(label, secs, card, extra=""):
    med = statistics.median(secs)
    print(f"{label}: {' '.join(f'{s * 1e3:.2f}' for s in secs)} ms (median "
          f"{med * 1e3:.2f}, min {min(secs) * 1e3:.2f}, max "
          f"{max(secs) * 1e3:.2f}){extra} | {card}")
    return med


def serve_viewer(torch, card, counted, httpd, label, kernel, expect_runs,
                 sync):
    """Drive a viewer server through its routes: the page and state, 409
    before a frame, a warm-up frame at another camera, VIEWER_FRAMES
    progressive frames at the state's camera (each between a reset and a
    read of the launch counters: ``kernel`` only, ``expect_runs``
    launches; on the card K3's, which replayed tile graphs launch without
    a launcher call, are counted in the device trace of one more frame), a
    camera move, a batch frame, a screenshot.  Returns the camera, the
    frames' generator indices and seconds, and the accumulator (mean,
    count) and u8 frame after the first and the last progressive frame."""
    import tempfile
    import threading

    from distributionraytracer_tpu_torch.utils.image import read_png

    state = httpd.state
    port = httpd.server_address[1]

    def accumulator():
        if hasattr(state, "prog_state"):
            return (state.prog_state[0].clone(), float(state.prog_state[1]),
                    state.last_rgb)
        return state.mean.copy(), state.count, state.last_rgb

    H, W = (state.renderer.scene.static.res_y,
            state.renderer.scene.static.res_x) \
        if hasattr(state, "renderer") else (state.res_y, state.res_x)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        status, page, _, _ = http_get(port, "/")
        check(status == 200 and b"distributionraytracer_tpu_torch" in page
              and f'width="{W}" height="{H}"'.encode() in page,
              f"{label}: page ({status})")
        st = json.loads(http_get(port, "/state")[1])
        check(st["progressive"] is True and {"alpha", "beta", "r"} <= set(st),
              f"{label}: state {st}")
        check(http_get(port, "/screenshot")[0] == 409,
              f"{label}: a screenshot before any frame is not a 409")
        check(http_get(port, "/nothing")[0] == 404,
              f"{label}: an unknown route is not a 404")
        cam = f"alpha={st['alpha']}&beta={st['beta']}&r={st['r']}"
        moved = f"alpha={st['alpha'] + 30.0}&beta={st['beta']}&r={st['r']}"
        (status, _, hdrs, s_warm), _, _ = counted(
            f"{label} /frame warm-up at another camera",
            lambda: http_get(port, f"/frame?{moved}&progressive=1"),
            {kernel: True})
        check(status == 200 and float(hdrs["X-Samples"]) == 1.0,
              f"{label}: warm-up frame {status}, {hdrs}")
        secs, seeds, acc = [], [], {}
        # K3 on the card: the Renderer's tile graphs
        graphed = kernel == "K3" and state.renderer.device.type == "cuda"
        for i in range(1, VIEWER_FRAMES + 1):
            (status, body, hdrs, s), runs, _ = counted(
                f"{label} /frame {i}",
                lambda: http_get(port, f"/frame?{cam}&progressive=1"),
                {kernel: True})
            check(status == 200 and body[:4] == b"\x89PNG"
                  and float(hdrs["X-Samples"]) == i
                  and hdrs["Cache-Control"] == "no-store",
                  f"{label} /frame {i}: {status}, {hdrs}")
            check(graphed or runs[kernel] == expect_runs,
                  f"{label} /frame {i}: {runs[kernel]} {kernel} launches, "
                  f"not {expect_runs}")
            secs.append(s)
            seeds.append(state.frame_i)
            acc[i] = accumulator()
        if graphed:
            prof = profile_frame(
                torch, lambda: http_get(port, f"/frame?{cam}&progressive=1"),
                secs[-1], f"{label} /frame {VIEWER_FRAMES + 1}")
            n = kernel_sum(prof, "whitted_level_kernel")[0]
            check(n == expect_runs, f"{label}: {n} K3 kernels in a warm "
                  f"frame's device trace, not {expect_runs}")
            print(f"{label}: {n} K3 launches a warm frame in its device "
                  f"trace ({expect_runs} expected)  PASS")
        eye = state._eye()
        (status, _, hdrs, _), _, _ = counted(
            f"{label} /frame after a camera move",
            lambda: http_get(port, f"/frame?{moved}&progressive=1"),
            {kernel: True})
        check(status == 200 and float(hdrs["X-Samples"]) == 1.0,
              f"{label}: a camera move gave {hdrs.get('X-Samples')} samples")
        (status, _, hdrs, s_batch), _, _ = counted(
            f"{label} /frame progressive=0",
            lambda: http_get(port, f"/frame?{moved}&progressive=0"),
            {kernel: True})
        check(status == 200, f"{label}: batch frame {status}")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "shot.png")
            status, body, _, _ = http_get(port, f"/screenshot?path={path}")
            check(status == 200 and json.loads(body)["path"] == path,
                  f"{label}: screenshot {status} {body}")
            shot = read_png(path)
        check(shot.shape == (H, W, 3) and shot.std() > 0.02,
              f"{label}: screenshot {shot.shape}, std {shot.std()}")
        print(f"{label}: page, state, 409 before a frame, 404, a warm-up "
              f"frame ({s_warm:.4f} s), {VIEWER_FRAMES} progressive frames "
              f"(X-Samples 1...{VIEWER_FRAMES}), a camera move (X-Samples "
              f"1), a batch frame (X-Samples {hdrs['X-Samples']}, "
              f"{s_batch:.4f} s), a screenshot read back as {shot.shape}  "
              "PASS")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    check(not server.is_alive(), f"{label}: the server thread did not stop")
    sync()
    return eye, seeds, secs, acc[1], acc[VIEWER_FRAMES]


def viewer_phase(torch, np, card, counted, dev, scene=None,
                 pt_res=(800, 600), sync=None):
    """Phase 11: both viewer states served on 127.0.0.1 on ``dev`` (the
    card; a CPU rehearsal passes its own scene, size and ``sync``)."""
    from distributionraytracer_tpu_torch import viewer as V
    from distributionraytracer_tpu_torch.config import RenderConfig
    from distributionraytracer_tpu_torch.integrator import pathtracer as PT
    from distributionraytracer_tpu_torch.integrator.render import (
        default_config,
    )
    from distributionraytracer_tpu_torch.renderer import Renderer
    from distributionraytracer_tpu_torch.scene import create_random_scene
    from distributionraytracer_tpu_torch.utils.image import png_bytes

    sync = sync or torch.cuda.synchronize
    scene = create_random_scene(0) if scene is None else scene
    st = scene.static
    cfg = default_config(scene, spp=16)
    k3_runs = -(-st.res_x * st.res_y // cfg.tile_rays) * (cfg.max_depth + 1)
    httpd = V.make_server(scene, cfg, port=0, device=dev)
    check(httpd.state.renderer.executed_backend() == "fused-level",
          f"viewer route {httpd.state.renderer.executed_backend()}")
    label = f"Whitted viewer {st.res_x}x{st.res_y}"
    eye, seeds, secs, first, last = serve_viewer(
        torch, card, counted, httpd, label, "K3", k3_runs, sync)

    def replay(c, frames):
        """(accumulators after each frame, seconds of each step):
        ``Renderer.progressive_step`` at the viewer's camera on the
        generators of ``frames``."""
        r = Renderer(scene, c, device=dev)
        r.scene = dataclasses.replace(
            r.scene, cam_eye=torch.as_tensor(eye, device=r.device))
        state, outs, steps = r.progressive_init(), [], []
        for i in frames:
            gen = V._frame_generator(r.device, 0, i)
            sync()
            t0 = time.perf_counter()
            state = r.progressive_step(state, gen)
            sync()
            steps.append(time.perf_counter() - t0)
            outs.append(state)
        return outs, steps

    outs, steps = replay(cfg, seeds)
    plain = replay(cfg.replace(kernels="off"), seeds[:1])[0][0][0]
    mean, count = outs[-1]
    d5 = float((last[0] - mean).abs().max())
    check(last[1] == float(count) == VIEWER_FRAMES and d5 == 0.0,
          f"{label}: accumulator after {VIEWER_FRAMES} frames vs "
          f"Renderer.progressive_step: max difference {d5}")
    # one sample a pixel: a lane that flips at a measure-zero edge keeps its
    # whole difference (16-spp slabs average it), so the pixels beyond 3e-3
    # are held to the kernels' lane budget instead of a maximum
    diff = (first[0] - plain).abs()
    out = float((diff > 3e-3).float().mean())
    px = (diff > 3e-3).any(-1)
    check(out <= 0.005 and float(px.float().mean()) <= LANE_BUDGET
          and float(plain.std()) > 0.05, f"{label}: first frame vs plain "
          f"torch: {out:.4%} beyond 3e-3, {int(px.sum())} pixels")
    print(f"{label}: accumulator after {VIEWER_FRAMES} frames vs "
          f"Renderer.progressive_step on the same generators and eye: max "
          f"difference {d5:.1e}; first frame vs kernels='off': {out:.4%} of "
          f"elements beyond 3e-3, {int(px.sum())} pixels of "
          f"{px.numel()} ({float(px.float().mean()):.2e}, lane budget "
          f"{LANE_BUDGET:.0e}), max diff {float(diff.max()):.4f}  PASS")
    rgb = last[2]
    png = [timed_host(lambda: png_bytes(rgb)) for _ in range(VIEWER_FRAMES)]
    med = spread(f"{label} /frame request, {VIEWER_FRAMES} frames", secs,
                 card, f", {1.0 / statistics.median(secs):.2f} frames/s")
    spread(f"{label} render (Renderer.progressive_step, synchronised)",
           steps, card)
    pmed = spread(f"{label} PNG encoding (png_bytes, {len(png_bytes(rgb))} "
                  "bytes)", png, card)
    rest = med - statistics.median(steps) - pmed
    print(f"{label}: request - render - PNG (medians) {rest * 1e3:.2f} ms: "
          f"the copy to the host, to_u8 and HTTP | {card}")

    pcfg = RenderConfig(max_bounces=10)
    pw, ph = pt_res
    tiles = -(-pw * ph // pcfg.pt_tile_rays)
    pstate = V.PTViewerState(0, pcfg, res=pt_res, chunk_spp=1, device=dev)
    phttpd = V.make_server(None, None, 0, state=pstate)
    plabel = f"PT viewer {pw}x{ph}"
    peye, pseeds, psecs, _, plast = serve_viewer(
        torch, card, counted, phttpd, plabel, "K6loop", tiles, sync)
    mean, psteps = np.zeros((ph, pw, 3), np.float32), []
    for i, seed in enumerate(pseeds, 1):
        gen = V._frame_generator(pstate.device, 0, seed)
        sync()
        t0 = time.perf_counter()
        img = PT.render_pt(pstate.scene, pcfg, pw, ph, gen, eye=peye,
                           at=pstate.at, spp=1)
        sync()
        psteps.append(time.perf_counter() - t0)
        mean = mean + (img.cpu().numpy() - mean) * (1 / i)
    pd = float(np.abs(plast[0] - mean).max())
    check(plast[1] == VIEWER_FRAMES and pd == 0.0 and mean.std() > 0.05,
          f"{plabel}: accumulator vs {VIEWER_FRAMES} render_pt calls: max "
          f"difference {pd}")
    print(f"{plabel}: accumulator after {VIEWER_FRAMES} frames vs "
          f"{VIEWER_FRAMES} render_pt calls on the same generators and eye, "
          f"folded by the same rule: max difference {pd:.1e}  PASS")
    prgb = plast[2]
    ppng = [timed_host(lambda: png_bytes(prgb)) for _ in range(VIEWER_FRAMES)]
    med = spread(f"{plabel} /frame request, {VIEWER_FRAMES} frames", psecs,
                 card, f", {1.0 / statistics.median(psecs):.2f} frames/s")
    spread(f"{plabel} render (render_pt, synchronised)", psteps, card)
    pmed = spread(f"{plabel} PNG encoding (png_bytes, "
                  f"{len(png_bytes(prgb))} bytes)", ppng, card)
    rest = med - statistics.median(psteps) - pmed
    print(f"{plabel}: request - render - PNG (medians) {rest * 1e3:.2f} "
          f"ms: the copy to the host, the mean, gamma, to_u8 and HTTP | "
          f"{card}")


def timed_host(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from distributionraytracer_tpu_torch.accel import cuda_binned as CBN
    from distributionraytracer_tpu_torch.accel import cuda_bvh as CBV
    from distributionraytracer_tpu_torch.config import RenderConfig
    from distributionraytracer_tpu_torch.integrator import pathtracer as PT
    from distributionraytracer_tpu_torch.integrator.render import (
        _rays_from_samples, default_config, make_samples,
        render_from_samples,
    )
    from distributionraytracer_tpu_torch.integrator.whitted import (
        _tree_shape, brute_intersectors,
    )
    from distributionraytracer_tpu_torch.ops import build
    from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
    from distributionraytracer_tpu_torch.ops import cuda_pt as CP
    from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
    from distributionraytracer_tpu_torch.ops.common import OFFSET
    from distributionraytracer_tpu_torch.ops.intersect import (
        _type_tmats, any_hit_brute, closest_hit_brute,
    )
    from distributionraytracer_tpu_torch.renderer import Renderer
    from distributionraytracer_tpu_torch.scene import (
        SCENE_BUILDERS, SceneBuilder, create_random_scene,
    )
    from distributionraytracer_tpu_torch.scene.pt_scenes import SKY_GRADIENT
    from distributionraytracer_tpu_torch.scene.types import OBJ_SPHERE

    card = card_line()
    dev = torch.device("cuda")
    print(card)
    t_run = time.perf_counter()

    def phase(name):
        print(f"phase {name}: {time.perf_counter() - t_run:.1f} s into "
              "the run")

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ---- 1. build ----
    phase("1 (build)")
    built = build.load()
    print(f"build: {os.path.relpath(built.path, REPO)} in "
          f"{built.seconds:.2f}s (0.00 = already built)")
    if built.compile_seconds:
        cs = built.compile_seconds
        print("build: nvcc side by side, per source "
              + ", ".join(f"{k} {v:.2f}s" for k, v in cs.items())
              + f"; one after another would take about "
              f"{sum(cs.values()):.2f}s before the link")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    for k, lines in ptxas_report(built.log, ("closest_hit_kernel",
                                             "closest_items_kernel",
                                             "whitted_level_kernel",
                                             "pt_bounce_kernel_loop",
                                             "pt_bounce_kernel",
                                             "pt_any_hit_kernel",
                                             "any_hit_kernel",
                                             "pt_closest_kernel",
                                             "binned_shadow_kernel",
                                             "shadow_chains_kernel",
                                             "shadow_items_kernel",
                                             *WALK_KERNELS)).items():
        print(f"ptxas {k}: {'; '.join(lines)}")

    # ---- 2. Whitted kernels vs plain on the four-primitive scene ----
    phase("2")
    rng = np.random.default_rng(0)
    R = 65536

    def rays(n, spread=3.0):
        o = rng.normal(0, spread, (n, 3)).astype(np.float32)
        d = rng.normal(0, 1, (n, 3))
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                torch.from_numpy(rng.random(n).astype(np.float32)).to(dev))

    def frac(mask):
        return float(mask.float().mean())

    def off_lanes(a, b, lim):
        """Lanes where a component of a is farther than lim from b (NaN
        counts as off)."""
        off = ~((a - b).abs() <= lim)
        return off if off.dim() == 1 else off.any(-1)

    def max_err(pairs, lanes):
        errs = [float((a[lanes] - b[lanes]).abs().max())
                for a, b in pairs if bool(lanes.any())]
        return max(errs, default=0.0)

    # A lane differs when a flag or id differs or a float is outside its
    # tolerance; at most LANE_BUDGET of the lanes may: those are the
    # measure-zero edges (hit/miss, and tangent sphere hits, whose t and
    # normal are ill-conditioned), where FMA contraction moves results.
    def cmp_closest(scene, o, d, t, mb, valid):
        ref = closest_hit_brute(scene, o, d, t, mb)
        h = CI.closest_hit_kernel(scene, o, d, t, mb, valid=valid)
        torch.cuda.synchronize()
        ids = valid & ((ref.hit != h.hit) | (ref.obj_id != h.obj_id)
                       | (ref.hit & (ref.mat_id != h.mat_id)))
        same = valid & ~ids & ref.hit
        bad = ids | (same & (
            off_lanes(h.t, ref.t, 1e-4 + 1e-4 * ref.t.abs())
            | off_lanes(h.normal, ref.normal, 1e-4 + 1e-4 * ref.normal.abs())))
        check(frac(bad) <= LANE_BUDGET, f"K1: {frac(bad)} of lanes differ")
        return max_err([(h.t, ref.t), (h.normal, ref.normal)],
                       same & ~bad), frac(bad)

    def cmp_any(scene, o, d, dist, ex, mode, valid=None):
        ref = any_hit_brute(scene, o, d, torch.zeros_like(dist), dist, ex,
                            False, mode=mode)
        occ = CI.any_hit_kernel(scene, o, d, dist, ex, False, mode=mode,
                                valid=valid)
        torch.cuda.synchronize()
        bad = ref != occ if valid is None else valid & (ref != occ)
        check(frac(bad) <= LANE_BUDGET, f"K2[{mode}]: {frac(bad)} differ")
        return float(bad.float().max()), frac(bad)

    def cmp_level(scene, cfg, args, spawn):
        valid = args[-1]
        ref = CW.fused_level_plain(scene, cfg, *args, spawn=spawn)
        res = CW.fused_level_kernel(scene, cfg, *args, spawn=spawn)
        torch.cuda.synchronize()
        bad = torch.zeros_like(valid)
        floats = []
        for k, a in ref.items():
            if a.dtype == torch.bool:
                bad |= a != res[k]
                continue
            floats.append((res[k], a))
            # points: 1e-5 of their magnitude; the rest: atol 2e-4
            lim = (1e-5 * torch.clamp(a.abs().amax(-1, keepdim=True),
                                      min=1.0)
                   if k in POINT_KEYS else 2e-4)
            bad |= off_lanes(res[k], a, lim)
        bad &= valid
        check(frac(bad) <= LANE_BUDGET, f"K3: {frac(bad)} of lanes differ")
        return max_err(floats, valid & ~bad), frac(bad)

    ks = kernel_scene(SceneBuilder).to(dev)
    errs = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5", "K6",
                             "K6loop")}
    for mb in (False, True):
        o, d, t = rays(R)
        valid = torch.rand(R, device=dev) < 0.9
        e, m = cmp_closest(ks, o, d, t, mb, valid)
        errs["K1"] = max(errs["K1"], e)
        print(f"K1 closest_hit motion_blur={mb}: lanes differing {m:.2e}, "
              f"max abs err elsewhere {e:.3e}  PASS")
    for mode in ("none", "grid", "bvh"):
        o, d, _ = rays(R)
        dist = torch.rand(R, device=dev) * 6
        ex = torch.randint(-1, ks.static.n_objects, (R,), device=dev,
                           dtype=torch.int32)
        e, m = cmp_any(ks, o, d, dist, ex, mode)
        errs["K2"] = max(errs["K2"], e)
        print(f"K2 any_hit mode={mode}: lanes differing {m:.2e}  PASS")
    for spawn in (True, False):
        o, d, t = rays(R)
        ior = torch.where(torch.rand(R, device=dev) < 0.3, 1.5, 1.0)
        ls = torch.cat([torch.rand(R, 2, device=dev),
                        torch.zeros(R, 1, device=dev)], 1)
        valid = torch.rand(R, device=dev) < 0.8
        lcfg = default_config(ks, motion_blur=True)
        e, m = cmp_level(ks, lcfg, [o, d, t, ior, ls, valid], spawn)
        errs["K3"] = max(errs["K3"], e)
        print(f"K3 fused_level spawn={spawn} motion_blur=True: lanes "
              f"differing {m:.2e}, max abs err elsewhere {e:.3e}  PASS")
        # as the tree loop launches it: 4 nodes of R / 4 rays, dead lanes
        rays_ = CI.ray_streams(R, o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                               d[:, 1], d[:, 2], t, ior, ls[:, 0], ls[:, 1],
                               valid.float())
        for kinds in ((("refr", "refl"), ("refl",)) if spawn else ((),)):
            e, m = cmp_level_into(torch, CW, ks, lcfg, rays_, R // 4, kinds,
                                  spawn)
            errs["K3"] = max(errs["K3"], e)
            print(f"K3 fused_level_into spawn={spawn} kinds={kinds}: lanes "
                  f"differing {m:.2e}, max abs err elsewhere {e:.3e}  PASS")

    # ---- 3. path-tracer kernels vs plain, scenes 0 and 3 ----
    phase("3")
    def cmp_pt_closest(scene, o, d, tm):
        ref = PT.hit_world(scene, o, d, tm)
        h = CP.pt_closest_kernel(scene, o, d, tm)
        torch.cuda.synchronize()
        same = (ref.hit == h.hit) & (~ref.hit | (ref.mat == h.mat))
        both = same & ref.hit
        bad = ~same | (both & off_lanes(h.t, ref.t, 2e-4 * ref.t.abs()))
        check(frac(bad) <= LANE_BUDGET, f"K4: {frac(bad)} of lanes differ")
        nrm = frac(off_lanes(h.normal, ref.normal, 1e-3)[both])
        check(nrm < 0.005, f"K4: normals beyond 1e-3 on {nrm} of the hits")
        return max_err([(h.t, ref.t), (h.normal, ref.normal)],
                       both & ~bad), frac(bad), nrm

    def cmp_pt_any(scene, o, d, tm, tmax):
        ref = PT.any_hit(scene, o, d, tm, 1e-3, tmax)
        occ = CP.pt_any_hit_kernel(scene, o, d, tm, tmax)
        torch.cuda.synchronize()
        bad = ref != occ
        check(frac(bad) <= LANE_BUDGET, f"K5: {frac(bad)} of lanes differ")
        return frac(bad), frac(ref)

    def cmp_pt_bounce(scene, state, uni):
        ref = CP.pt_bounce_plain(scene, state.clone(), uni, True)
        got = CP.pt_bounce_kernel(scene, state.clone(), uni, True)
        torch.cuda.synchronize()
        bad = (ref[CP.ST_ALIVE] > 0) != (got[CP.ST_ALIVE] > 0)
        o_lim = 1e-5 * torch.clamp(ref[CP.ST_O].abs().amax(0), min=1.0)
        bad |= off_lanes(got[CP.ST_O].T, ref[CP.ST_O].T, o_lim[:, None])
        bad |= off_lanes(got[3:].T, ref[3:].T, 2e-3 + 2e-3 * ref[3:].T.abs())
        check(frac(bad) <= LANE_BUDGET, f"K6: {frac(bad)} of lanes differ")
        return max_err([(got.T, ref.T)], ~bad), frac(bad), frac(
            ref[CP.ST_ALIVE] > 0)

    def cmp_pt_trace(scene, o, d, tm, uniforms, rr):
        """The looped K6 against its plain version (B plain bounces) on the
        paths' colours (and latched miss rows): each bounce may flip
        LANE_BUDGET of the lanes."""
        B = uniforms.uch.shape[0]
        ref = CP.pt_trace_plain(scene, o, d, tm, uniforms, rr)
        got = CP.pt_trace_kernel(scene, o, d, tm, uniforms, rr)
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
        bad = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for a, b in pairs:
            bad |= off_lanes(a, b, 2e-3 + 2e-3 * b.abs())
        check(frac(bad) <= B * LANE_BUDGET,
              f"looped K6: {frac(bad)} of lanes differ from {B} plain "
              f"bounces")
        return max_err(pairs, ~bad), frac(bad), got

    def pt_scene(si):
        args = () if si == 0 else synthetic_faces(np, si)
        return SCENE_BUILDERS[si](*args).to(dev)

    for si in (0, 3):
        sc = pt_scene(si)
        o, d, tm = rays(R, spread=5.0)
        if si == 3:  # origins inside the open Cornell box
            o = torch.rand(R, 3, device=dev) * torch.tensor(
                [24.0, 24.0, 10.0], device=dev) + torch.tensor(
                [-12.0, -12.0, 15.0], device=dev)
        e, m, nrm = cmp_pt_closest(sc, o, d, tm)
        errs["K4"] = max(errs["K4"], e)
        print(f"K4 pt_closest scene {si}: lanes differing {m:.2e}, normals "
              f"beyond 1e-3 on {nrm:.2e} of hits, max abs err elsewhere "
              f"{e:.3e}  PASS")
        tmax = torch.rand(R, device=dev) * 20 + 0.5
        m, occ = cmp_pt_any(sc, o, d, tm, tmax)
        print(f"K5 pt_any_hit scene {si}: lanes differing {m:.2e} "
              f"(occluded {occ:.3f})  PASS")
        eye, lo, hi = ([6, 1.6, -6], [-6, 0, -6], [6, 2, 6]) if si == 0 else (
            [0, -3, -4], [-12, -12, 15], [12, 12, 25])
        f3 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        tgt = f3(lo) + torch.rand(R, 3, device=dev) * (f3(hi) - f3(lo))
        po = f3(eye).expand(R, 3)
        pd = torch.nn.functional.normalize(tgt - po, dim=-1)
        state = CP.bounce_state(po.contiguous(), pd, tm)
        g = torch.Generator(device=dev).manual_seed(si)
        nq = sc.qlight_pos.shape[0]
        for b in range(4):
            u = PT.draw_uniforms(sc, R, g, dev)
            uni = CP.bounce_streams(u.uch, u.u3a, u.u3b, u.urr, u.uq, nq)
            if b in (0, 3):
                e, m, alive = cmp_pt_bounce(sc, state, uni)
                errs["K6"] = max(errs["K6"], e)
                print(f"K6 pt_bounce scene {si} bounce {b}: lanes differing "
                      f"{m:.2e}, alive after {alive:.3f}, max abs err "
                      f"elsewhere {e:.3e}  PASS")
            CP.pt_bounce_plain(sc, state, uni, True)
        e, m, _ = cmp_pt_trace(sc, po.contiguous(), pd, tm,
                               PT.draw_bounces(sc, R, 4, g, dev), True)
        errs["K6loop"] = max(errs["K6loop"], e)
        print(f"K6 pt_trace (looped) scene {si}, 4 bounces: lanes differing "
              f"{m:.2e}, max abs err elsewhere {e:.3e}  PASS")

    # ---- 4. the Whitted frame: 800x600, 16 spp, depth 4, three routes ----
    phase("4")
    def reset_launches():
        for m in (CI, CW, CP, CBV, CBN):
            m.reset_launches()

    def launches():
        bv = CBV.LAUNCHES
        return {"K1": CI.LAUNCHES["closest_hit"],
                "K2": CI.LAUNCHES["any_hit"],
                "K3": CW.LAUNCHES["fused_level"],
                "K3grid": CW.LAUNCHES["fused_level_grid"],
                "K4": CP.LAUNCHES["pt_closest"],
                "K5": CP.LAUNCHES["pt_any_hit"],
                "K6": CP.LAUNCHES["pt_bounce"],
                "K6loop": CP.LAUNCHES["pt_trace"],
                "K7": bv["grouped_closest"] + bv["grouped_shadow"],
                "K8": bv["legacy_closest"] + bv["legacy_shadow"],
                "K9": CBN.LAUNCHES["binned_closest"],
                "K10": CBN.LAUNCHES["binned_shadow"]}

    def counted(label, render, expect):
        """Run ``render`` between a reset and a read of the launch
        counters; ``expect`` says which kernels must launch (True) and
        which must not (False)."""
        reset_launches()
        replays = CW.GRAPHS["replays"]
        t0 = time.perf_counter()
        out = render()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launches()
        replays = CW.GRAPHS["replays"] - replays
        print(f"{label}: launches {got}, graph replays {replays}, "
              f"{seconds:.4f} s")
        for k in got:
            # a replayed tile graph runs K3 without a launcher call
            ran = got[k] > 0 or (k == "K3" and replays > 0)
            check(ran == expect.get(k, False),
                  f"{label}: {k} launched {got[k]} times, graph replays "
                  f"{replays}")
        return out, got, seconds

    scene = create_random_scene(0)
    cfg = default_config(scene, spp=16)
    r = Renderer(scene, cfg, device="cuda")
    check(r.executed_backend() == "fused-level",
          f"route {r.executed_backend()}")
    dark = Renderer(without_lights(scene), cfg, device="cuda")
    check(dark.executed_backend() == "brute-kernel",
          f"light-less route {dark.executed_backend()}")
    samples = make_samples(r.scene, cfg,
                           torch.Generator(device=dev).manual_seed(0))
    a, b = SLAB
    slab = samples.rows(a, b)
    plain_cfg = cfg.replace(kernels="off", tile_rays=16384)

    (img, nrays), _, cold_s = counted(
        "Whitted main path, Renderer.render_with_samples (fused-level route)",
        lambda: r.render_with_samples(samples, return_rays=True),
        {"K3": True})
    dark_img, dark_runs, _ = counted(
        "Renderer.render_with_samples without lights (brute-kernel route)",
        lambda: dark.render_with_samples(samples), {"K1": True})
    (staged_img, staged_rays), staged_runs, staged_s = counted(
        "render_from_samples(inter=brute_intersectors) (staged kernel "
        "route with lights)",
        lambda: render_from_samples(r.scene, cfg, samples, return_rays=True,
                                    inter=brute_intersectors(r.scene, cfg)),
        {"K1": True, "K2": True})

    H, W = scene.static.res_y, scene.static.res_x
    for name, im in (("fused", img), ("light-less", dark_img),
                     ("staged", staged_img)):
        check(tuple(im.shape) == (H, W, 3), f"{name} image shape "
              f"{tuple(im.shape)}")
        check(bool(torch.isfinite(im).all()), f"{name}: non-finite pixels")
        check(float(im.std()) > 0.05, f"{name}: constant image")
    check(abs(int(nrays) - int(staged_rays)) <= 1e-3 * int(nrays),
          f"ray counts: fused {int(nrays)}, staged {int(staged_rays)}")

    plain_slab = render_from_samples(r.scene, plain_cfg, slab, row_offset=a)
    dark_plain = render_from_samples(dark.scene, plain_cfg, slab,
                                     row_offset=a)
    for name, got, ref in (("fused", img[a:b], plain_slab),
                           ("staged", staged_img[a:b], plain_slab),
                           ("light-less", dark_img[a:b], dark_plain)):
        diff = (got - ref).abs()
        out = frac(diff > 3e-3)
        check(out <= 0.005 and float(diff.max()) <= 0.05,
              f"{name} slab vs plain: {out:.4%} beyond 3e-3, max "
              f"{float(diff.max()):.4f}")
        print(f"frame rows {a}:{b} {name} kernels vs plain torch: "
              f"{out:.4%} of elements beyond 3e-3, max diff "
              f"{float(diff.max()):.4f}  PASS")

    torch.cuda.reset_peak_memory_stats()
    frames = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        img2, nrays2 = r.render_with_samples(samples, return_rays=True)
        torch.cuda.synchronize()
        frames.append(time.perf_counter() - t0)
        check(torch.equal(img, img2) and int(nrays) == int(nrays2),
              "two renders of one SampleSet differ")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(frames)
    print(f"frame 800x600 spp16 depth4 fused-level: {len(frames)} warm "
          f"frames {' '.join(f'{s:.4f}' for s in frames)} s (median "
          f"{med:.4f}, min {min(frames):.4f}, max {max(frames):.4f}; first "
          f"{cold_s:.4f} s), {int(nrays)} rays, {int(nrays) / med:.4e} "
          f"rays/s at the median, peak {peak_gb:.2f} GiB | {card}")
    print(f"frame staged kernel route: {staged_s:.4f} s (one warm frame) | "
          f"{card}")
    # K3's launches a frame, from the device trace: a replayed graph
    # launches its kernels without a launcher call.  The frame without ray
    # counts first captures its own graphs, unprofiled.
    r.render_with_samples(samples)
    wprof = profile_frame(torch, lambda: r.render_with_samples(samples), med,
                          "Whitted frame")
    main_k3 = kernel_sum(wprof, "whitted_level_kernel")[0]
    k3_expect = -(-H * W * cfg.spp // cfg.tile_rays) * (cfg.max_depth + 1)
    check(main_k3 == k3_expect, f"Whitted main path: {main_k3} K3 kernels "
          f"in the device trace of a warm frame, not {k3_expect}")
    print(f"Whitted main path: {main_k3} K3 launches a warm frame in its "
          f"device trace ({k3_expect} expected)  PASS")

    # ---- 5. the path-traced frame: scene 0, 800x600, 16 spp, 10 bounces --
    phase("5")
    pf = PT_FRAME
    PW, PH = pf["res"]
    pts = SCENE_BUILDERS[pf["scene"]]().to(dev)
    pcfg = RenderConfig(max_bounces=pf["bounces"])
    paths = PW * PH * pf["spp"]
    tiles = -(-paths // pcfg.pt_tile_rays)
    n_pl = pts.plight_pos.shape[0]

    def pt_frame(queries=None):
        g = torch.Generator(device=dev).manual_seed(0)
        return PT.render_pt(pts, pcfg, PW, PH, g, eye=pf["eye"], at=pf["at"],
                            spp=pf["spp"], queries=queries)

    pimg, pt_runs, pt_cold = counted(
        "path-tracer main path, render_pt (fused body)", pt_frame,
        {"K6loop": True})
    check(pt_runs["K6loop"] == tiles,
          f"the looped K6 launched {pt_runs['K6loop']} times, not once a "
          f"tile ({tiles})")
    pstaged, pst_runs, pst_s = counted(
        "render_pt(queries=kernel_queries) (staged body)",
        lambda: pt_frame(PT.kernel_queries(pts)), {"K4": True, "K5": True})
    check(pst_runs["K4"] == tiles * pcfg.max_bounces
          and pst_runs["K5"] == tiles * pcfg.max_bounces * n_pl,
          f"staged body launches {pst_runs}")
    for name, im in (("fused", pimg), ("staged", pstaged)):
        check(tuple(im.shape) == (PH, PW, 3), f"PT {name} image shape "
              f"{tuple(im.shape)}")
        check(bool(torch.isfinite(im).all()), f"PT {name}: non-finite")
        check(float(im.std()) > 0.05, f"PT {name}: constant image")
    pdiff = abs(float(pimg.mean() - pstaged.mean()))
    check(pdiff < 5e-3, f"PT frames: fused and staged means differ by "
          f"{pdiff}")

    g = torch.Generator(device=dev).manual_seed(1)
    jit = torch.rand((b - a, PW, pf["spp"], 2), generator=g, device=dev)
    stime = torch.rand((b - a, PW, pf["spp"]), generator=g,
                       device=dev).reshape(-1)
    so, sd = PT.primary_rays(PW, PH, jit, pf["eye"], pf["at"], row_offset=a)
    rs = so.shape[0]
    nq = max(pts.qlight_pos.shape[0], 1)
    su = PT.BounceUniforms(*(
        torch.rand((pcfg.max_bounces,) + sh, generator=g, device=dev)
        for sh in ((rs, 2 * nq), (rs,), (rs, 3), (rs, 3), (rs,))))

    def pt_slab(c, q=None):
        col = PT.ray_color_tiled(pts, c, so, sd, stime, uniforms=su,
                                 queries=q)
        return col.reshape(b - a, PW, pf["spp"], 3).mean(2)

    ref_slab = pt_slab(pcfg.replace(kernels="off"))
    check(float(ref_slab.std()) > 0.05, "PT plain slab is constant")
    for name, got in (("fused", pt_slab(pcfg)),
                      ("staged", pt_slab(pcfg, PT.kernel_queries(pts)))):
        diff = (got - ref_slab).abs()
        out = frac(diff > 1e-3)
        mdiff = abs(float(got.mean() - ref_slab.mean()))
        check(out < 0.05 and mdiff < 5e-3,
              f"PT {name} slab vs plain: {out:.4%} beyond 1e-3, mean "
              f"difference {mdiff:.2e}")
        print(f"PT rows {a}:{b} ({rs} paths) {name} kernels vs plain torch: "
              f"{out:.4%} of elements beyond 1e-3, |mean difference| "
              f"{mdiff:.2e}, max diff {float(diff.max()):.4f}  PASS")

    torch.cuda.reset_peak_memory_stats()
    pframes = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        pimg2 = pt_frame()
        torch.cuda.synchronize()
        pframes.append(time.perf_counter() - t0)
        check(torch.equal(pimg, pimg2), "two PT frames of one seed differ")
    ppeak = torch.cuda.max_memory_allocated() / 2**30
    pmed = statistics.median(pframes)
    print(f"PT frame 800x600 spp16 10 bounces scene 0 (fused body): "
          f"{len(pframes)} warm frames "
          f"{' '.join(f'{s:.4f}' for s in pframes)} s (median {pmed:.4f}, "
          f"min {min(pframes):.4f}, max {max(pframes):.4f}; first "
          f"{pt_cold:.4f} s), {paths} paths, {paths / pmed / 1e6:.4f} "
          f"Msamples/s at the median, peak {ppeak:.2f} GiB | {card}")
    print(f"PT frame staged body (K4+K5): {pst_s:.4f} s (one warm frame), "
          f"{paths / pst_s / 1e6:.4f} Msamples/s | {card}")

    # ---- 5b. the accelerated frame: 100,000 triangles, five routes ----
    phase("5b")
    acc = accel_phase(torch, np, dev, card, counted)
    # ---- 5c. the box-ground frame: K10 on the binned+ routes ----
    phase("5c")
    lit = light_phase(torch, np, dev, card, counted)

    # ---- 6. kernel times and bounds at the main paths' shapes ----
    phase("6")
    def w_normal_ops(sc, h, mb):
        """The winners' normals, once per hit lane."""
        per = torch.tensor([W_NORMAL_OPS[t] + int(mb and t == OBJ_SPHERE)
                            for t in sc.static.obj_types],
                           dtype=torch.float64, device=dev)
        return float(per[h.obj_id[h.hit].long()].sum())

    def w_shadow_ops(sc, o, d, dist, excl, mb, lanes):
        """any_fold's operations (mode none, time 0) on these rays: every
        test up to the first occluder, or all of them; lanes only.  Also
        returns which rays are occluded."""
        n_obj = sc.static.n_objects
        okm = torch.zeros((o.shape[0], n_obj), dtype=torch.bool, device=dev)
        zt = torch.zeros_like(dist)
        for _typ, gids, tmat in _type_tmats(sc, o, d, zt, mb):
            okm[:, gids.long()] = ((tmat < dist[:, None]) & (tmat > 1e-4)
                                   & (gids[None, :] != excl[:, None]))
        cum = torch.cumsum(w_test_ops(torch, sc, o, d, zt, mb), 1)
        first = torch.where(okm.any(1), okm.float().argmax(1), n_obj - 1)
        return (float(cum.gather(1, first[:, None])[:, 0][lanes].sum()),
                okm.any(1))

    def pt_shadow_ops(sc, o, d, tm, tmax, lanes):
        """K5's fold on these rays: d.d, then every test up to the first
        occluder in table order, or all of them; lanes only.  Also returns
        which rays are occluded."""
        a_dd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        oks = []
        if sc.tri_v0.shape[0]:
            t_, ok = PT._tri_t(sc, o, d, 1e-3)
            oks.append(ok & (t_ < tmax))
        if sc.sph_center.shape[0]:
            t_, ok = PT._sph_t(sc, o, d, a_dd, 1e-3)
            oks.append(ok & (t_ < tmax))
        if sc.msph_c0.shape[0]:
            t_, ok = PT._msph_quadratic(sc, o, d, tm, a_dd, 1e-3)[:2]
            oks.append(ok & (t_ < tmax))
        okm = torch.cat(oks)
        cum = torch.cumsum(pt_test_ops(torch, PT, sc, o, d, tm), 0)
        first = torch.where(okm.any(0), okm.float().argmax(0),
                            okm.shape[0] - 1)
        fold = cum.gather(0, first[None])[0]
        return float((PT_FOLD_OPS + fold)[lanes].sum()), okm.any(0)

    def k6_bounce_ops(state, u, rr):
        """FP32 operations of one K6 bounce on ``state``'s live lanes (a
        dead lane costs nothing: the block compacts its live lanes) with
        the bounce's uniforms ``u`` (every lane's): the closest fold, the
        winner, the hit or miss, the scatter, roulette's survivors, and
        each light's work with its shadow fold (time 0, as K6 casts)."""
        live = state[CP.ST_ALIVE] > 0
        o, d = (state[r_].T[live].contiguous() for r_ in (CP.ST_O, CP.ST_D))
        t = state[CP.ST_TIME][live].contiguous()
        n = o.shape[0]
        if n == 0:
            return 0.0
        h = PT.hit_world(pts, o, d, t)
        hits = float(h.hit.sum())
        nrm = torch.nn.functional.normalize(h.normal, dim=-1)
        t0 = torch.zeros(n, device=dev)
        uni = CP.bounce_streams(u.uch, u.u3a, u.u3b, u.urr, u.uq,
                                pts.qlight_pos.shape[0])
        survive = CP.pt_bounce_plain(pts, state.clone(), uni, rr)[
            CP.ST_ALIVE] > 0
        mid = h.mat.long()
        mtyp = pts.mat_type[mid].long()
        gradient = pts.sky_mode == SKY_GRADIENT
        ops = (n * PT_FOLD_OPS
               + float(pt_test_ops(torch, PT, pts, o, d, t).sum())
               + (n - hits) * PT_MISS_OPS * gradient
               + hits * (PT_WINNER_OPS + PT_HIT_OPS)
               + float((h.hit & pts.mat_stripe[mid]).sum()) * PT_STRIPE_OPS
               + float((h.hit & (pts.mat_emissive[mid] != 0).any(-1)).sum())
               * PT_EMIT_OPS
               + float(survive.sum()) * PT_SURVIVE_OPS)
        per_typ = lambda table: torch.tensor(table, dtype=torch.float64,
                                             device=dev)[mtyp]
        ops += float(per_typ(PT_SCATTER_OPS)[h.hit].sum())
        light_ops = PT_LIGHT_OPS + per_typ(PT_LIGHT_RGB_OPS)
        for j in range(pts.plight_pos.shape[0]):
            lu = pts.plight_pos[j] - h.pos
            dist = torch.sqrt(torch.clamp((lu * lu).sum(-1), min=1e-24))
            lj = lu / dist[:, None]
            facing = h.hit & ((nrm * lj).sum(-1) > 0)
            fold, occ = pt_shadow_ops(pts, h.pos + nrm * 1e-3, lj, t0,
                                      dist - 1e-3, facing)
            ops += (hits * PT_POINT_OPS + float(facing.sum()) * PT_SHADOW_OPS
                    + fold + float(light_ops[facing & ~occ].sum()))
        uq = u.uq[live]
        for j in range(pts.qlight_pos.shape[0]):
            lp = (pts.qlight_pos[j] + pts.qlight_e1[j] * uq[:, 2 * j, None]
                  + pts.qlight_e2[j] * uq[:, 2 * j + 1, None])
            facing = h.hit & ((nrm * (lp - h.pos)).sum(-1) > 0)
            ops += hits * PT_QUAD_OPS + float(
                (light_ops + PT_QUAD_GGX_OPS)[facing].sum())
        return ops

    rows = []
    meta = {
        "K1": ("closest_hit", "intersect.cu", "distributionraytracer_tpu/"
               "ops/pallas_intersect.py:331"),
        "K2": ("any_hit", "intersect.cu", "distributionraytracer_tpu/ops/"
               "pallas_intersect.py:374"),
        "K3": ("fused_level", "whitted_level.cu", "distributionraytracer_"
               "tpu/ops/pallas_whitted.py:320"),
        "K4": ("pt_closest", "pt.cu", "distributionraytracer_tpu/ops/"
               "pallas_pt.py:285"),
        "K5": ("pt_any_hit", "pt.cu", "distributionraytracer_tpu/ops/"
               "pallas_pt.py:312"),
        "K6": ("pt_bounce", "pt.cu", "distributionraytracer_tpu/ops/"
               "pallas_pt.py:767"),
        "K6loop": ("pt_bounce_loop", "pt.cu", "distributionraytracer_tpu/"
                   "integrator/pathtracer.py:535"),
    }
    route_of = {"K1": ("brute-kernel route frame", dark_runs["K1"]),
                "K2": ("staged kernel route frame", staged_runs["K2"]),
                "K3": ("Whitted main path frame", main_k3),
                "K4": ("PT staged body frame", pst_runs["K4"]),
                "K5": ("PT staged body frame", pst_runs["K5"]),
                "K6": ("PT main path frame (none: the looped K6 runs there)",
                       pt_runs["K6"]),
                "K6loop": ("PT main path frame", pt_runs["K6loop"])}

    def row(k, lanes, bare, wrapper, plain, nbytes, ops, setup=None):
        ms = timed_ms(torch, bare, 20, setup)
        wrapper_ms = timed_ms(torch, wrapper, 20, setup)
        plain_ms = timed_ms(torch, plain, 5, setup)
        b_ms, b_by = bound(nbytes, ops)
        name, src, rep = meta[k]
        run, count = route_of[k]
        print(f"{k} {name}: kernel {ms:.4f} ms (with the wrapper's packing "
              f"{wrapper_ms:.4f}), plain torch {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP) at {lanes} lanes | {card}")
        rows.append({"name": name, "route": "cuda",
                     "source": f"distributionraytracer_tpu_torch/csrc/{src}",
                     "replaces": rep, "launches": count, "run": run,
                     "max_abs_err": errs[k], "ms": ms,
                     "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})

    # K1 to K3: one 65,536-sample tile of the Whitted frame
    o, d, t, ls = (x[:cfg.tile_rays].contiguous()
                   for x in _rays_from_samples(r.scene, cfg, samples))
    n = o.shape[0]
    sc, mb = r.scene, cfg.motion_blur
    n_obj, n_l = sc.static.n_objects, sc.static.n_lights
    h = closest_hit_brute(sc, o, d, t, mb)
    tab = CI.object_tables(sc)
    p = o + d * torch.where(h.hit, h.t, torch.ones_like(h.t))[:, None]
    lights = sc.light_pos
    nl = lights.shape[0]
    sd_ = torch.nn.functional.normalize(lights[:, None, :] - p[None], dim=-1)
    so_ = (p + h.normal * 1e-4).repeat(nl, 1)
    sd_ = sd_.reshape(-1, 3).contiguous()
    sdist = torch.ones(nl * n, device=dev)
    sex = h.obj_id.repeat(nl)
    svalid = h.hit.repeat(nl)
    e1, _ = cmp_closest(sc, o, d, t, mb, torch.ones_like(h.hit))
    e2, _ = cmp_any(sc, so_, sd_, sdist, sex, "none", valid=svalid)
    ones, allv = torch.ones(n, device=dev), torch.ones_like(h.hit)
    ltab = CW.level_tables(sc)
    # level 0 of the tile as the tree loop launches it: one node of n rays
    kinds = _tree_shape(sc, cfg)[0]
    rays3 = CI.ray_streams(n, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                           d[:, 2], t, ones, ls[:, 0], ls[:, 1], ones)
    e3, _ = cmp_level_into(torch, CW, sc, cfg, rays3, n, kinds, tables=ltab)
    for k, e in (("K1", e1), ("K2", e2), ("K3", e3)):
        errs[k] = max(errs[k], e)
    f4 = lambda k: k * 4
    closest_ops = float(w_test_ops(torch, sc, o, d, t, mb).sum())

    # K1 reads o, d, time and writes HitResult: hit (a byte), t, normal,
    # object and material ids; its tables: the type runs and ids, and the
    # insertion-order rows, types and materials
    launch1, _ = closest_hit_launch(torch, CI, dict(
        scene=sc, o=o, d=d, time=t, motion_blur=mb, valid=None, tables=tab))
    row("K1", n, launch1,
        lambda: CI.closest_hit_kernel(sc, o, d, t, mb, tables=tab),
        lambda: closest_hit_brute(sc, o, d, t, mb),
        n * (f4(7 + 1 + 3 + 2) + 1) + f4(tab.runs.numel()) + n_obj * f4(16),
        closest_ops + w_normal_ops(sc, h, mb))

    launch2, _ = any_hit_launch(torch, CI, dict(
        scene=sc, o=so_, d=sd_, max_dist=sdist, exclude_obj=sex,
        motion_blur=mb, mode="none", valid=svalid, tables=tab))
    row("K2", nl * n, launch2,
        lambda: CI.any_hit_kernel(sc, so_, sd_, sdist, sex, mb, valid=svalid,
                                  tables=tab),
        lambda: any_hit_brute(sc, so_, sd_, torch.zeros_like(sdist), sdist,
                              sex, mb),
        nl * n * (f4(6 + 1 + 1) + 1 + 1) + n_obj * f4(13),
        w_shadow_ops(sc, so_, sd_, sdist, sex, mb, svalid)[0])

    # K3's own shadow rays (fused_level_plain's construction)
    nn_ = CW._norm3(h.normal)
    N_ = nn_ * torch.where((d * nn_).sum(-1) < 0, 1.0, -1.0)[:, None]
    k3_light = 0.0
    for j in range(n_l):
        lp = ltab.lights[j, 0:3].expand(n, 3)
        if sc.static.light_quad[j]:
            lp = (lp + ltab.lights[j, 3:6] * ls[:, 0:1]
                  + ltab.lights[j, 6:9] * ls[:, 1:2])
            k3_light += n * W_QUAD_OPS
        ul = lp - p
        L_ = ul / torch.sqrt(torch.clamp((ul * ul).sum(-1), min=1e-24))[:,
                                                                       None]
        ops_j, occ_j = w_shadow_ops(sc, p + N_ * OFFSET, L_,
                                    torch.ones(n, device=dev), h.obj_id, mb,
                                    h.hit)
        k3_light += (ops_j + n * W_LIGHT_OPS
                     + float((h.hit & ~occ_j).sum()) * W_SHADE_OPS)
    lv = CW.fused_level_plain(sc, cfg, o, d, t, ones, ls, allv, True,
                              tables=ltab)
    k3_spawn = (n * W_SPAWN_OPS
                + float((~((d * nn_).sum(-1) < 0)).sum()) * W_BEER_OPS
                + float(lv["refr_valid"].sum()) * W_REFR_OPS
                + float(lv["refl_valid"].sum()) * W_REFL_OPS)
    # it reads the 11 rays rows, writes the combine's 10 rows and each
    # child's 11 rows of the next level
    nk = len(kinds)
    out3 = torch.empty((len(CW.COMBINE_ROWS), n), device=dev)
    next3 = torch.empty((11, nk * n), device=dev)
    row("K3", n, lambda: CW.launch_level(ltab, n_obj, rays3, cfg, True, out3,
                                         None, next3, n, kinds),
        lambda: CW.level_into_kernel(sc, cfg, rays3, next3, n, kinds,
                                     tables=ltab),
        lambda: CW.level_into_plain(sc, cfg, rays3, next3, n, kinds,
                                    tables=ltab),
        n * f4(11 + 10 + 11 * nk) + n_obj * f4(12 + 1 + 13) + n_l * f4(10),
        closest_ops + n * W_LANE_OPS + w_normal_ops(sc, h, mb) + k3_light
        + k3_spawn)

    # K4 to K6: the first 131,072-path tile of the PT frame at bounce 0
    # (render_pt's own draws: jitter, then time, from the seed)
    g = torch.Generator(device=dev).manual_seed(0)
    jit = torch.rand((PH, PW, pf["spp"], 2), generator=g, device=dev)
    ftime = torch.rand((PH, PW, pf["spp"]), generator=g,
                       device=dev).reshape(-1)
    fo, fd = PT.primary_rays(PW, PH, jit, pf["eye"], pf["at"])
    o, d, t = (x[:pcfg.pt_tile_rays].contiguous() for x in (fo, fd, ftime))
    n = o.shape[0]
    ptb = CP.pt_tables(pts)
    T, S, M = ptb.counts
    K = T + S + M
    pt_closest_ops = (n * PT_FOLD_OPS
                      + float(pt_test_ops(torch, PT, pts, o, d, t).sum()))
    h = PT.hit_world(pts, o, d, t)
    hits = float(h.hit.sum())
    e4, _, _ = cmp_pt_closest(pts, o, d, t)

    # K4 reads o, d, time and writes PTHit: hit (a byte), t, pos, normal,
    # material; pos = o + d * s is 6 operations a lane
    launch4, _ = pt_closest_launch(torch, CP, dict(
        scene=pts, o=o, d=d, time=t, tables=ptb))
    row("K4", n, launch4,
        lambda: CP.pt_closest_kernel(pts, o, d, t, tables=ptb),
        lambda: PT.hit_world(pts, o, d, t),
        n * (f4(7 + 1 + 3 + 3 + 1) + 1) + K * f4(12 + 1),
        pt_closest_ops + hits * PT_WINNER_OPS + n * 6)

    # K5: the staged body's shadow rays towards point light 0
    nrm = torch.nn.functional.normalize(h.normal, dim=-1)
    lu = pts.plight_pos[0] - h.pos
    dist = torch.linalg.norm(lu, dim=-1)
    o5 = (h.pos + nrm * 1e-3).contiguous()
    d5 = torch.nn.functional.normalize(lu, dim=-1).contiguous()
    t5, tmax5 = torch.zeros(n, device=dev), dist - 1e-3
    _, _ = cmp_pt_any(pts, o5, d5, t5, tmax5)
    launch5, _ = pt_any_hit_launch(torch, CP, dict(
        scene=pts, o=o5, d=d5, time=t5, tmax=tmax5, tables=ptb))
    row("K5", n, launch5,
        lambda: CP.pt_any_hit_kernel(pts, o5, d5, t5, tmax5, tables=ptb),
        lambda: PT.any_hit(pts, o5, d5, t5, 1e-3, tmax5),
        n * (f4(8) + 1) + K * f4(12),
        pt_shadow_ops(pts, o5, d5, t5, tmax5, torch.ones_like(h.hit))[0])

    # K6: one bounce of the tile's camera rays, the state restored before
    # each launch (untimed)
    st0 = CP.bounce_state(o, d, t)
    u = PT.draw_uniforms(pts, n, g, dev)
    uni = CP.bounce_streams(u.uch, u.u3a, u.u3b, u.urr, u.uq,
                            pts.qlight_pos.shape[0])
    e6, _, _ = cmp_pt_bounce(pts, st0, uni)
    errs["K6"] = max(errs["K6"], e6)
    errs["K4"] = max(errs["K4"], e4)
    k6_ops = k6_bounce_ops(st0, u, True)
    st = st0.clone()
    restore = lambda: st.copy_(st0)
    row("K6", n,
        lambda: CP.launch_bounce(ptb, st, uni, True, True),
        lambda: CP.pt_bounce_kernel(pts, st, uni, True, tables=ptb),
        lambda: CP.pt_bounce_plain(pts, st, uni, True, tables=ptb),
        n * f4(2 * CP.STATE_ROWS + uni.shape[0]) + K * f4(12 + 16)
        + n_pl * f4(6), k6_ops, setup=restore)

    def add_row(k, count, run, lanes, bare, wrapper, plain, nbytes, ops,
                shape):
        """``plain``: the plain version, timed here; or its milliseconds,
        measured once where it was held against the kernel (K10's plain
        version takes ~10 s a call)."""
        ms = timed_ms(torch, bare, 20)
        wrapper_ms = timed_ms(torch, wrapper, 20)
        plain_ms = plain if isinstance(plain, float) else timed_ms(
            torch, plain, 1)
        b_ms, b_by = bound(nbytes, ops)
        name, src, rep = ACCEL_META[k]
        print(f"{k} {name}: kernel {ms:.4f} ms (with the wrapper's packing "
              f"{wrapper_ms:.4f}), plain torch {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP); {shape} | {card}")
        rows.append({"name": name, "route": "cuda",
                     "source": f"distributionraytracer_tpu_torch/csrc/{src}",
                     "replaces": rep, "launches": count, "run": run,
                     "max_abs_err": errs[k], "ms": ms,
                     "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})

    accel_rows(torch, np, dev, card, acc, errs, add_row)
    light_rows(torch, dev, card, lit, errs, add_row)
    # K7 at each launch of its frame, K8's and K7's sums over their frames
    walk_sums = walk_rows(torch, card, acc)

    # ---- 7b. K3 per level and K6 per bounce on one tile of each frame ----
    phase("7b")
    levels, e = level_breakdown(torch, dev, card, r.scene, cfg, samples)
    errs["K3"] = max(errs["K3"], e)
    bounces, btile = bounce_breakdown(torch, card, pts, pcfg,
                                      pf["res"][0] * pf["res"][1] * pf["spp"],
                                      pt_frame, cmp_pt_bounce, cmp_pt_trace)
    # the looped K6 on that tile: one launch for its every bounce.  Its
    # floor: the camera rays read and the colours written once; each bounce
    # with live paths reads their uniform rows and the tables; the state
    # stays in the block's shared memory.
    errs["K6loop"] = max(errs["K6loop"], btile["err"])
    bo, bd, bt, bu, brr = (btile[k_] for k_ in ("o", "d", "time", "uniforms",
                                                "rr"))
    n = bo.shape[0]
    n_ql = pts.qlight_pos.shape[0]
    buni = CP._trace_uniforms(bu, n, n_ql)
    grad_sky = pts.sky_mode == SKY_GRADIENT
    rows3 = lambda: torch.empty((n, 3), device=dev)
    bout = CP.Traced(rows3(), None if grad_sky else rows3(),
                     None if grad_sky else rows3())
    n_live = [int((st_[CP.ST_ALIVE] > 0).sum()) for st_ in btile["states"]]
    loop_ops = sum(k6_bounce_ops(st_, bu.bounce(b_), brr)
                   for b_, st_ in enumerate(btile["states"]) if n_live[b_])
    loop_bytes = (n * f4(7 + (3 if grad_sky else 9))
                  + sum(nl * f4(CP.UNIFORM_ROWS + 2 * n_ql)
                        + K * f4(12 + 16) + n_pl * f4(6) + n_ql * f4(12)
                        for nl in n_live if nl))
    print(f"K6 looped launch (tile {btile['tile']}): live paths a bounce "
          f"{n_live} | {card}")
    row("K6loop", n,
        lambda: CP.launch_trace(ptb, bo, bd, bt, buni, brr, grad_sky, bout),
        lambda: CP.pt_trace_kernel(pts, bo, bd, bt, bu, brr, tables=ptb),
        lambda: CP.pt_trace_plain(pts, bo, bd, bt, bu, brr, tables=ptb),
        loop_bytes, loop_ops)
    # ---- 7c. K2 and K5 at each launch of the staged frames ----
    phase("7c")
    cost = {"bvh": (acc["cb"], acc["samples"]),
            "grid": (acc["cbg"], acc["samples"])}
    staged_breakdown(torch, card, r.scene, cfg, samples, pts, pcfg, paths,
                     pt_frame, cost)
    k1_breakdown(torch, card, r.scene, cfg, samples, cost,
                 acc["runs"]["cost-brute"][0]["K1"], add_row, errs,
                 lambda sc, h, o, d, t, mb: float(
                     w_test_ops(torch, sc, o, d, t, mb).sum())
                 + w_normal_ops(sc, h, mb))
    staged_profiles(torch, card, r.scene, cfg, samples, pt_frame, pts)

    # ---- 7. profiles of one warm frame of each main path ----
    phase("8 (profiles)")
    pprof = profile_frame(torch, pt_frame, pmed, "PT frame")
    frame_sums(wprof, pprof, rows, levels, bounces, card)
    aprof = profile_frame(torch, lambda: acc["bvh"].render_with_samples(
        acc["samples"]), acc["median"], "accelerated frame")
    lprof = profile_frame(torch, lambda: acc["leg"].render_with_samples(
        acc["samples"]), acc["runs"]["legacy"][2], "legacy-packet frame")
    walk_frame_sums(aprof, lprof, rows, walk_sums, card)
    for key, label in (("bvh", "binned+ frame"),
                       ("off", "binned-primary+ box-ground frame")):
        bprof = profile_frame(torch, lambda r=lit[key]: r.render_with_samples(
            lit["samples"]), lit["median"]["bvh+" if key == "bvh" else "off"],
            label)
        if key == "bvh":  # K10: one kernel, or its three passes
            got = [kernel_sum(bprof, k) for k in (
                "binned_shadow_kernel", "shadow_chains_kernel",
                "shadow_scan_kernel", "shadow_items_kernel")]
            print(f"K10 in the profiled binned+ frame: "
                  f"{sum(n for n, _ in got)} device kernels, "
                  f"{sum(ms for _, ms in got):.3f} ms summed | {card}")

    # ---- 9. gradients: inverse-rendering steps on the K1/K2 route ----
    phase("9 (gradients)")
    grad_phase(torch, card, counted, r.scene, cfg, samples)
    phase("9 (grid gradients)")
    grid9 = grid_grad_phase(torch, card, counted, acc)

    # ---- 10. row sharding at world size 1 on NCCL ----
    phase("10 (sharded)")
    sharded_phase(torch, card, counted,
                  (r, cfg, samples, img, main_k3), acc, grid9)

    # ---- 11. the browser viewer over HTTP on 127.0.0.1 ----
    phase("11 (viewer)")
    viewer_phase(torch, np, card, counted, dev)

    phase("end")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
