#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit; exits non-zero without CUDA.
2. Builds the kernels from ``distributionraytracer_tpu_torch/csrc`` with
   nvcc (``ops/build.py``) and prints the build time and ptxas's register
   and spill report.
3. Holds each Whitted kernel against its plain torch version on the card,
   on 65,536 random rays against a scene with all four primitive types, a
   quad light and a point light:
   - K1 closest hit: hit/object/material ids equal, t and normal within
     rtol 1e-4, atol 1e-4;
   - K2 any hit: occlusion equal, in all three modes;
   - K3 fused level: spawn on and off, motion blur on, valid lanes: flags
     equal, child origins within 1e-5 of their magnitude, every other float
     within atol 2e-4;
   each but for at most 0.01% of the lanes (the measure-zero edges).
4. Holds each path-tracer kernel against its plain version on 65,536 lanes
   of scene 0 (triangles, spheres, moving spheres at times in [0, 1)) and
   scene 3 (quad light, cubemap sky with synthetic faces):
   - K4 closest: hit and material equal, t within rtol 2e-4, normals beyond
     1e-3 on under 0.5% of the hits;
   - K5 any hit: occlusion equal;
   - K6 bounce, from camera rays and from the state after three bounces,
     on the same uniforms: alive flags equal, origins within 1e-5 of their
     magnitude, every other state row within atol 2e-3 + rtol 2e-3;
   each but for at most 0.01% of the lanes.
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
   torch.cuda.synchronize and prints their spread and rays/s.
6. Path traces scene 0 at 800x600, 16 spp, 10 bounces through ``render_pt``
   in two counted runs: the path tracer's main path (the fused body): K6
   only, one launch per tile and bounce; the staged body with
   ``kernel_queries``: K4 and K5 only.  Puts the camera rays of rows
   284:316 (409,600 paths, uniforms drawn once) through ``ray_color`` on
   the fused kernel, the staged kernels and plain torch, and holds both
   kernel routes to plain with the statistic of test_pallas_pt (under 5%
   of elements beyond 1e-3, |mean difference| under 5e-3).  Times FRAMES
   warm frames and prints Msamples/s and the peak device memory.
7. Times each kernel and its plain version at its main path's shapes (K1
   to K3: one 65,536-sample tile of the Whitted frame; K4 to K6: one
   131,072-path tile at bounce 0 of the path-traced frame) with CUDA
   events: the bare launch on packed streams (``ms``) and the wrapper with
   its stream packing (``wrapper_ms``).  Beside each, the least time the
   card could take for the same work (``bound_ms``): the larger of the
   bytes over 3.35 TB/s and the FP32 operations over 67 TFLOP/s, counted
   from these inputs (tests up to the first occluder where a fold stops
   there; dead lanes skipped; per-lane branches as the constants below
   say).
8. Profiles one more warm frame of each main path under ``torch.profiler``
   and prints the device-busy time, the idle share and the top device
   kernels.

Prints the kernels' JSON line, then the result line last.  Any failure
raises, so the exit code is non-zero and no result line is printed.
"""

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
# adds one), and the winner's normal once per hit (the fold recomputes it
# at each closer hit; the repeats are not counted).
W_TEST_OPS = (33, 46, 13, 25)
W_NORMAL_OPS = (18, 19, 0, 7)
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
# triangle or sphere; a moving sphere's 24 or 30 are counted as 18).
PT_TEST_OPS = (46, 28, 53)
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


def profile_frame(torch, render, wall_s, label):
    """One frame under torch.profiler: device-busy ms (the union of the
    device activity intervals), its idle share of the unprofiled frame time
    ``wall_s``, the host ops and the top device activities by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    if not device:
        print(f"profile {label}: the profiler traced no device activity; "
              "device-busy time and idle share not measured")
        return
    busy_us, end = 0.0, float("-inf")
    for e in sorted(device, key=lambda e: e.time_range.start):
        s, t = max(e.time_range.start, end), e.time_range.end
        busy_us += max(t - s, 0.0)
        end = max(end, t)
    busy_ms = busy_us / 1e3
    print(f"profile {label}: device busy {busy_ms:.3f} ms of a "
          f"{wall_s * 1e3:.3f} ms frame (idle share "
          f"{1 - busy_ms / (wall_s * 1e3):.4f}); {len(device)} device "
          f"activities from {len(host)} host events")
    by_name = {}
    for e in device:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    for name, (n, us) in top[:10]:
        print(f"  {name[:64]:64s} {n:6d} x {us / 1e3:9.3f} ms")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from distributionraytracer_tpu_torch.config import RenderConfig
    from distributionraytracer_tpu_torch.integrator import pathtracer as PT
    from distributionraytracer_tpu_torch.integrator.render import (
        _rays_from_samples, default_config, make_samples,
        render_from_samples,
    )
    from distributionraytracer_tpu_torch.integrator.whitted import (
        brute_intersectors,
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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build ----
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

    # ---- 2. Whitted kernels vs plain on the four-primitive scene ----
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
    errs = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5", "K6")}
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

    # ---- 3. path-tracer kernels vs plain, scenes 0 and 3 ----
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

    # ---- 4. the Whitted frame: 800x600, 16 spp, depth 4, three routes ----
    def reset_launches():
        CI.reset_launches()
        CW.reset_launches()
        CP.reset_launches()

    def launches():
        return {"K1": CI.LAUNCHES["closest_hit"],
                "K2": CI.LAUNCHES["any_hit"],
                "K3": CW.LAUNCHES["fused_level"],
                "K4": CP.LAUNCHES["pt_closest"],
                "K5": CP.LAUNCHES["pt_any_hit"],
                "K6": CP.LAUNCHES["pt_bounce"]}

    def counted(label, render, expect):
        """Run ``render`` between a reset and a read of the launch
        counters; ``expect`` says which kernels must launch (True) and
        which must not (False)."""
        reset_launches()
        t0 = time.perf_counter()
        out = render()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launches()
        print(f"{label}: launches {got}, {seconds:.4f} s")
        for k in got:
            check((got[k] > 0) == expect.get(k, False),
                  f"{label}: {k} launched {got[k]} times")
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

    (img, nrays), main_runs, cold_s = counted(
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

    # ---- 5. the path-traced frame: scene 0, 800x600, 16 spp, 10 bounces --
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
        {"K6": True})
    check(pt_runs["K6"] == tiles * pcfg.max_bounces,
          f"pt_bounce launched {pt_runs['K6']} times, not "
          f"{tiles} tiles x {pcfg.max_bounces} bounces")
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

    # ---- 6. kernel times and bounds at the main paths' shapes ----
    def w_fold_ops(sc, mb):
        per = [W_TEST_OPS[t] + int(mb and t == OBJ_SPHERE)
               for t in sc.static.obj_types]
        return per

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
        cum = torch.cumsum(torch.tensor(w_fold_ops(sc, mb),
                                        dtype=torch.float64, device=dev), 0)
        first = torch.where(okm.any(1), okm.float().argmax(1), n_obj - 1)
        return float(cum[first][lanes].sum()), okm.any(1)

    def pt_shadow_ops(sc, o, d, tm, tmax, lanes):
        """K5's fold on these rays: d.d, then every test up to the first
        occluder in table order, or all of them; lanes only.  Also returns
        which rays are occluded."""
        a_dd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        oks, per = [], []
        if sc.tri_v0.shape[0]:
            t_, ok = PT._tri_t(sc, o, d, 1e-3)
            oks.append(ok & (t_ < tmax))
            per += [PT_TEST_OPS[0]] * sc.tri_v0.shape[0]
        if sc.sph_center.shape[0]:
            t_, ok = PT._sph_t(sc, o, d, a_dd, 1e-3)
            oks.append(ok & (t_ < tmax))
            per += [PT_TEST_OPS[1]] * sc.sph_center.shape[0]
        if sc.msph_c0.shape[0]:
            t_, ok = PT._msph_quadratic(sc, o, d, tm, a_dd, 1e-3)[:2]
            oks.append(ok & (t_ < tmax))
            per += [PT_TEST_OPS[2]] * sc.msph_c0.shape[0]
        okm = torch.cat(oks)
        cum = torch.cumsum(torch.tensor(per, dtype=torch.float64,
                                        device=dev), 0)
        first = torch.where(okm.any(0), okm.float().argmax(0),
                            okm.shape[0] - 1)
        return float((PT_FOLD_OPS + cum[first])[lanes].sum()), okm.any(0)

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
    }
    route_of = {"K1": ("brute-kernel route frame", dark_runs["K1"]),
                "K2": ("staged kernel route frame", staged_runs["K2"]),
                "K3": ("Whitted main path frame", main_runs["K3"]),
                "K4": ("PT staged body frame", pst_runs["K4"]),
                "K5": ("PT staged body frame", pst_runs["K5"]),
                "K6": ("PT main path frame", pt_runs["K6"])}

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
    e3, _ = cmp_level(sc, cfg, [o, d, t, ones, ls, allv], True)
    for k, e in (("K1", e1), ("K2", e2), ("K3", e3)):
        errs[k] = max(errs[k], e)
    ltab = CW.level_tables(sc)
    f4 = lambda k: k * 4
    closest_ops = sum(w_fold_ops(sc, mb))

    rays1 = CI.ray_streams(n, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                           d[:, 2], t, ones)
    of1 = torch.empty((4, n), device=dev)
    oi1 = torch.empty((2, n), dtype=torch.int32, device=dev)
    row("K1", n, lambda: CI.launch_closest_hit(tab, n_obj, rays1, mb, of1,
                                               oi1),
        lambda: CI.closest_hit_kernel(sc, o, d, t, mb, tables=tab),
        lambda: closest_hit_brute(sc, o, d, t, mb),
        n * f4(8 + 4 + 2) + n_obj * f4(14),
        n * closest_ops + w_normal_ops(sc, h, mb))

    rays2 = CI.ray_streams(nl * n, so_[:, 0], so_[:, 1], so_[:, 2],
                           sd_[:, 0], sd_[:, 1], sd_[:, 2], sdist,
                           svalid.float())
    ex2 = sex.to(torch.int32).contiguous()
    occ2 = torch.empty((nl * n,), dtype=torch.bool, device=dev)
    row("K2", nl * n,
        lambda: CI.launch_any_hit(tab, n_obj, rays2, ex2, "none", mb, occ2),
        lambda: CI.any_hit_kernel(sc, so_, sd_, sdist, sex, mb, valid=svalid,
                                  tables=tab),
        lambda: any_hit_brute(sc, so_, sd_, torch.zeros_like(sdist), sdist,
                              sex, mb),
        nl * n * (f4(8 + 1) + 1) + n_obj * f4(13),
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
    rays3 = CI.ray_streams(n, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                           d[:, 2], t, ones, ls[:, 0], ls[:, 1], ones)
    out3 = torch.empty((29, n), device=dev)
    row("K3", n, lambda: CW.launch_level(ltab, n_obj, rays3, cfg, True, out3),
        lambda: CW.fused_level_kernel(sc, cfg, o, d, t, ones, ls, allv, True,
                                      tables=ltab),
        lambda: CW.fused_level_plain(sc, cfg, o, d, t, ones, ls, allv, True,
                                     tables=ltab),
        n * f4(11 + 29) + n_obj * f4(12 + 1 + 13) + n_l * f4(10),
        n * (closest_ops + W_LANE_OPS) + w_normal_ops(sc, h, mb) + k3_light
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
    pt_closest_ops = (PT_FOLD_OPS + T * PT_TEST_OPS[0] + S * PT_TEST_OPS[1]
                      + M * PT_TEST_OPS[2])
    h = PT.hit_world(pts, o, d, t)
    hits = float(h.hit.sum())
    e4, _, _ = cmp_pt_closest(pts, o, d, t)

    rays4 = CI.ray_streams(n, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                           d[:, 2], t)
    of4 = torch.empty((4, n), device=dev)
    oi4 = torch.empty((n,), dtype=torch.int32, device=dev)
    row("K4", n, lambda: CP.launch_closest(ptb, rays4, of4, oi4),
        lambda: CP.pt_closest_kernel(pts, o, d, t, tables=ptb),
        lambda: PT.hit_world(pts, o, d, t),
        n * f4(7 + 4 + 1) + K * f4(12 + 1),
        n * pt_closest_ops + hits * PT_WINNER_OPS)

    # K5: the staged body's shadow rays towards point light 0
    nrm = torch.nn.functional.normalize(h.normal, dim=-1)
    lu = pts.plight_pos[0] - h.pos
    dist = torch.linalg.norm(lu, dim=-1)
    o5 = (h.pos + nrm * 1e-3).contiguous()
    d5 = torch.nn.functional.normalize(lu, dim=-1).contiguous()
    t5, tmax5 = torch.zeros(n, device=dev), dist - 1e-3
    _, _ = cmp_pt_any(pts, o5, d5, t5, tmax5)
    rays5 = CI.ray_streams(n, o5[:, 0], o5[:, 1], o5[:, 2], d5[:, 0],
                           d5[:, 1], d5[:, 2], t5, tmax5)
    occ5 = torch.empty((n,), dtype=torch.bool, device=dev)
    row("K5", n, lambda: CP.launch_any_hit(ptb, rays5, occ5),
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
    mid = h.mat.long()
    mtyp = pts.mat_type[mid].long()
    survive = CP.pt_bounce_plain(pts, st0.clone(), uni, True)[
        CP.ST_ALIVE] > 0
    gradient = pts.sky_mode == SKY_GRADIENT
    k6_ops = (n * pt_closest_ops + (n - hits) * PT_MISS_OPS * gradient
              + hits * (PT_WINNER_OPS + PT_HIT_OPS)
              + float((h.hit & pts.mat_stripe[mid]).sum()) * PT_STRIPE_OPS
              + float((h.hit & (pts.mat_emissive[mid] != 0).any(-1)).sum())
              * PT_EMIT_OPS
              + float(survive.sum()) * PT_SURVIVE_OPS)
    per_typ = lambda table: torch.tensor(table, dtype=torch.float64,
                                         device=dev)[mtyp]
    k6_ops += float(per_typ(PT_SCATTER_OPS)[h.hit].sum())
    light_ops = PT_LIGHT_OPS + per_typ(PT_LIGHT_RGB_OPS)
    for j in range(n_pl):
        lu = pts.plight_pos[j] - h.pos
        dist = torch.sqrt(torch.clamp((lu * lu).sum(-1), min=1e-24))
        lj = lu / dist[:, None]
        facing = h.hit & ((nrm * lj).sum(-1) > 0)
        fold, occ = pt_shadow_ops(pts, h.pos + nrm * 1e-3, lj, t5,
                                  dist - 1e-3, facing)
        k6_ops += (hits * PT_POINT_OPS + float(facing.sum()) * PT_SHADOW_OPS
                   + fold + float(light_ops[facing & ~occ].sum()))
    for j in range(pts.qlight_pos.shape[0]):
        lp = (pts.qlight_pos[j] + pts.qlight_e1[j] * u.uq[:, 2 * j, None]
              + pts.qlight_e2[j] * u.uq[:, 2 * j + 1, None])
        facing = h.hit & ((nrm * (lp - h.pos)).sum(-1) > 0)
        k6_ops += hits * PT_QUAD_OPS + float(
            (light_ops + PT_QUAD_GGX_OPS)[facing].sum())
    st = st0.clone()
    restore = lambda: st.copy_(st0)
    row("K6", n,
        lambda: CP.launch_bounce(ptb, st, uni, True, True),
        lambda: CP.pt_bounce_kernel(pts, st, uni, True, tables=ptb),
        lambda: CP.pt_bounce_plain(pts, st, uni, True, tables=ptb),
        n * f4(2 * CP.STATE_ROWS + uni.shape[0]) + K * f4(12 + 16)
        + n_pl * f4(6), k6_ops, setup=restore)

    # ---- 7. profiles of one warm frame of each main path ----
    profile_frame(torch, lambda: r.render_with_samples(samples), med,
                  "Whitted frame")
    profile_frame(torch, pt_frame, pmed, "PT frame")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
