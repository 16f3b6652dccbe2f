// Ray-primitive tests shared by the brute-force and packet kernels.
//
// Device counterparts of _sphere_step, _triangle_step, _plane_step and
// _box_step in distributionraytracer_tpu/ops/pallas_intersect.py, with the
// same formulas and the same reference quirks (scene.cpp:44-278):
//   sphere   nearest root with t > EPSILON; motion blur moves the centre by
//            (0,1,0)*time;
//   triangle Moller-Trumbore, a == 0 is a miss, t > EPSILON;
//   plane    parallel when |PN.D| < EPSILON, t > 0;
//   box      slab test, hit only when tmin > EPSILON; NaN-propagating
//            min/max as in jnp.minimum/maximum; face normal by an ordered
//            EPSILON compare of the hit point.
// A miss is FLT_MAX.  Built without --use_fast_math: the slab test divides
// by direction components that may be zero and needs IEEE inf.
//
// Objects live in a packed (O,12) f32 table in insertion order with an
// (O,) i32 type array (scene/types.py::packed_objects), in K2's type runs
// (ops/cuda_intersect.py::type_runs), or in the packet kernels' (S,16)
// slot records, read straight from global memory through __ldg: where
// every thread of a warp reads the same row, one broadcast, cached load
// per field; the split folds read a few rows at once, which stay in L1 all
// the same.  The <false> instances read rows a caller holds in registers
// (K2's type runs, loaded 16 bytes at a time).
//
// The end of this file holds the group folds that K1, K2 and K3 share:
// the closest-hit and any-hit folds split over a group of threads
// (lanes.cuh), in rounds of kUnroll objects, over the insertion-order
// table (MixedRows) or over type runs (TypedRows).  The closest hit
// (closest_group, K1 and K3) reduces the group's winners by (t, object
// id); the any-hit rounds (round_occludes) stop at an occluder: K3 votes
// by group (any_group), K2 keeps the warp together (any_warp).
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace drt {

constexpr float kEpsilon = 1e-3f;  // macros.h:1
constexpr float kFltMax = FLT_MAX;
constexpr int kRowWidth = 12;

enum ObjType { kSphere = 0, kTriangle = 1, kPlane = 2, kBox = 3 };

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A row field: through the read-only cache from global memory (kGlobal),
// or a plain load (rows a caller holds in registers).
template <bool kGlobal = true>
__device__ __forceinline__ float ld(const float* p, int i) {
  if constexpr (kGlobal) return __ldg(p + i);
  return p[i];
}

// One IEEE rounding per operation, never contracted into an FMA.
__device__ __forceinline__ float dot3_rn(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// The discriminant cancels catastrophically for small, distant spheres
// (b^2 ~ 4ac: a 0.2-radius sphere 13 units away keeps ~3 of b^2's 24 bits),
// so a single contracted multiply-add moves t and the normal visibly.  It
// is evaluated uncontracted, left to right, with the rounding of the
// reference (pallas_intersect.py::_sphere_step) and of the plain version.
// The sphere quadratic's b and discriminant; a = d.d is the caller's.
template <bool G = true>
__device__ __forceinline__ float sphere_disc(const Ray& r, const float* row,
                                             float time, bool motion_blur,
                                             float a, float* b_out) {
  float cx = ld<G>(row, 0), cy = ld<G>(row, 1), cz = ld<G>(row, 2);
  float rad = ld<G>(row, 3);
  if (motion_blur) cy = cy + time;
  float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
  float b = __fmul_rn(2.0f, dot3_rn(ocx, ocy, ocz, r.dx, r.dy, r.dz));
  float cq = __fsub_rn(dot3_rn(ocx, ocy, ocz, ocx, ocy, ocz),
                       __fmul_rn(rad, rad));
  *b_out = b;
  return __fsub_rn(__fmul_rn(b, b), __fmul_rn(__fmul_rn(4.0f, a), cq));
}

// The nearest root with t > EPSILON, or a miss.
__device__ __forceinline__ float sphere_root(float a, float b, float disc) {
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t1 = (-b - sq) / (2.0f * a);
  float t2 = (-b + sq) / (2.0f * a);
  float t = t1 > kEpsilon ? t1 : t2;
  return (disc >= 0.0f && t > kEpsilon) ? t : kFltMax;
}

// A miss (NaN included) needs no root: the IEEE sqrt and the two
// divisions are most of a test's instructions, and most tests miss.
__device__ __forceinline__ bool sphere_missed(float disc) {
  return !(disc >= 0.0f);
}

template <bool G = true>
__device__ __forceinline__ float sphere_t(const Ray& r, const float* row,
                                          float time, bool motion_blur) {
  const float a = dot3_rn(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  float b;
  const float disc = sphere_disc<G>(r, row, time, motion_blur, a, &b);
  return sphere_missed(disc) ? kFltMax : sphere_root(a, b, disc);
}

__device__ __forceinline__ float sub_mul_rn(float a, float b, float c,
                                            float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// Moller-Trumbore and the plane test decide hits at shared mesh edges and
// grazing angles, so they are uncontracted too, in the plain version's
// order (ops/intersect.py::hit_packed): the packet kernels must pick the
// same winner as the plain walk.
template <bool G = true>
__device__ __forceinline__ float triangle_t(const Ray& r, const float* row) {
  float v0x = ld<G>(row, 0), v0y = ld<G>(row, 1), v0z = ld<G>(row, 2);
  float e1x = ld<G>(row, 3), e1y = ld<G>(row, 4), e1z = ld<G>(row, 5);
  float e2x = ld<G>(row, 6), e2y = ld<G>(row, 7), e2z = ld<G>(row, 8);
  float hx = sub_mul_rn(r.dy, e2z, r.dz, e2y);
  float hy = sub_mul_rn(r.dz, e2x, r.dx, e2z);
  float hz = sub_mul_rn(r.dx, e2y, r.dy, e2x);
  float a = dot3_rn(e1x, e1y, e1z, hx, hy, hz);
  float f = __fdiv_rn(1.0f, a != 0.0f ? a : 1.0f);
  float sx = __fsub_rn(r.ox, v0x), sy = __fsub_rn(r.oy, v0y),
        sz = __fsub_rn(r.oz, v0z);
  float u = __fmul_rn(f, dot3_rn(sx, sy, sz, hx, hy, hz));
  float qx = sub_mul_rn(sy, e1z, sz, e1y);
  float qy = sub_mul_rn(sz, e1x, sx, e1z);
  float qz = sub_mul_rn(sx, e1y, sy, e1x);
  float v = __fmul_rn(f, dot3_rn(qx, qy, qz, r.dx, r.dy, r.dz));
  float t = __fmul_rn(f, dot3_rn(e2x, e2y, e2z, qx, qy, qz));
  bool ok = a != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
            __fadd_rn(u, v) <= 1.0f && t > kEpsilon;
  return ok ? t : kFltMax;
}

template <bool G = true>
__device__ __forceinline__ float plane_t(const Ray& r, const float* row) {
  float nx = ld<G>(row, 0), ny = ld<G>(row, 1), nz = ld<G>(row, 2);
  float pd = ld<G>(row, 3);
  float denom = dot3_rn(r.dx, r.dy, r.dz, nx, ny, nz);
  bool par_ok = fabsf(denom) >= kEpsilon;
  float t = __fdiv_rn(-__fadd_rn(dot3_rn(r.ox, r.oy, r.oz, nx, ny, nz), pd),
                      par_ok ? denom : 1.0f);
  return (par_ok && t > 0.0f) ? t : kFltMax;
}

template <bool G = true>
__device__ __forceinline__ float box_t(const Ray& r, const float* row) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float d[3] = {r.dx, r.dy, r.dz};
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float inv = 1.0f / d[k];
    float ta = (ld<G>(row, k) - o[k]) * inv;
    float tb = (ld<G>(row, 3 + k) - o[k]) * inv;
    float lo = min_nan(ta, tb);
    float hi = max_nan(ta, tb);
    tmin = k == 0 ? lo : max_nan(tmin, lo);
    tmax = k == 0 ? hi : min_nan(tmax, hi);
  }
  return (tmin <= tmax && tmin > kEpsilon) ? tmin : kFltMax;
}

template <bool G = true>
__device__ __forceinline__ float prim_t(int typ, const Ray& r,
                                        const float* row, float time,
                                        bool motion_blur) {
  switch (typ) {
    case kSphere: return sphere_t<G>(r, row, time, motion_blur);
    case kTriangle: return triangle_t<G>(r, row);
    case kPlane: return plane_t<G>(r, row);
    default: return box_t<G>(r, row);
  }
}

// U tests of one ray against rows row[u] of types typ[u], written so that
// their arithmetic can interleave (a lane's fold is a dependent chain, and
// a warp has few others to hide its latency behind): when all U are
// spheres, every discriminant first, then the roots of those that are not
// misses; when all are of another type, U tests of that type.
template <bool G, int U>
__device__ __forceinline__ void prim_t_n(const int* typ,
                                         const float* const* row,
                                         const Ray& r, float time,
                                         bool motion_blur, float* t) {
  bool same = true;
#pragma unroll
  for (int u = 1; u < U; ++u) same = same && typ[u] == typ[0];
  if (!same) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      t[u] = prim_t<G>(typ[u], r, row[u], time, motion_blur);
    return;
  }
  switch (typ[0]) {
    case kSphere: {
      const float a = dot3_rn(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
      float b[U], disc[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        disc[u] = sphere_disc<G>(r, row[u], time, motion_blur, a, &b[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        t[u] = sphere_missed(disc[u]) ? kFltMax
                                      : sphere_root(a, b[u], disc[u]);
      return;
    }
    case kTriangle:
#pragma unroll
      for (int u = 0; u < U; ++u) t[u] = triangle_t<G>(r, row[u]);
      return;
    case kPlane:
#pragma unroll
      for (int u = 0; u < U; ++u) t[u] = plane_t<G>(r, row[u]);
      return;
    default:
#pragma unroll
      for (int u = 0; u < U; ++u) t[u] = box_t<G>(r, row[u]);
  }
}

// Geometric normal of object `row` at ray parameter t (unflipped).
template <bool G = true>
__device__ __forceinline__ void prim_normal(int typ, const Ray& r,
                                            const float* row, float t,
                                            float time, bool motion_blur,
                                            float* n) {
  if (typ == kSphere) {
    // uncontracted, as the plain version: the normal steers the children,
    // and reflections off small spheres magnify its last-bit differences
    float cy = ld<G>(row, 1);
    if (motion_blur) cy = cy + time;
    float px = __fsub_rn(__fadd_rn(r.ox, __fmul_rn(r.dx, t)), ld<G>(row, 0));
    float py = __fsub_rn(__fadd_rn(r.oy, __fmul_rn(r.dy, t)), cy);
    float pz = __fsub_rn(__fadd_rn(r.oz, __fmul_rn(r.dz, t)), ld<G>(row, 2));
    float len = __fsqrt_rn(dot3_rn(px, py, pz, px, py, pz));
    n[0] = __fdiv_rn(px, len);
    n[1] = __fdiv_rn(py, len);
    n[2] = __fdiv_rn(pz, len);
  } else if (typ == kTriangle) {
    float e1x = ld<G>(row, 3), e1y = ld<G>(row, 4), e1z = ld<G>(row, 5);
    float e2x = ld<G>(row, 6), e2y = ld<G>(row, 7), e2z = ld<G>(row, 8);
    float nx = sub_mul_rn(e1y, e2z, e1z, e2y);
    float ny = sub_mul_rn(e1z, e2x, e1x, e2z);
    float nz = sub_mul_rn(e1x, e2y, e1y, e2x);
    float len = __fsqrt_rn(dot3_rn(nx, ny, nz, nx, ny, nz));
    n[0] = __fdiv_rn(nx, len);
    n[1] = __fdiv_rn(ny, len);
    n[2] = __fdiv_rn(nz, len);
  } else if (typ == kPlane) {
    n[0] = ld<G>(row, 0); n[1] = ld<G>(row, 1); n[2] = ld<G>(row, 2);
  } else {
    // ordered if/else chain; first matching face wins (scene.cpp:262-274)
    const float p[3] = {__fadd_rn(r.ox, __fmul_rn(r.dx, t)),
                        __fadd_rn(r.oy, __fmul_rn(r.dy, t)),
                        __fadd_rn(r.oz, __fmul_rn(r.dz, t))};
    n[0] = n[1] = n[2] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (fabsf(p[k] - ld<G>(row, k)) < kEpsilon) { n[k] = -1.0f; return; }
      if (fabsf(p[k] - ld<G>(row, 3 + k)) < kEpsilon) { n[k] = 1.0f; return; }
    }
  }
}

// Closest hit over all objects in insertion order, strict-< first wins
// (main.cpp:315-326).  Returns the winner's object id, or -1.  The
// winner's normal is computed once, after the fold (the same value as
// recomputing it at every closer hit).
__device__ __forceinline__ int closest_fold(const float* table,
                                            const int* types, int n_obj,
                                            const Ray& r, float time,
                                            bool motion_blur, float* best_t,
                                            float* n) {
  int best = -1;
  float bt = kFltMax;
  n[0] = n[1] = n[2] = 0.0f;
  for (int g = 0; g < n_obj; ++g) {
    const float t = prim_t(__ldg(types + g), r,
                           table + (size_t)g * kRowWidth, time, motion_blur);
    if (t < bt) {
      bt = t;
      best = g;
    }
  }
  if (best >= 0)
    prim_normal(__ldg(types + best), r, table + (size_t)best * kRowWidth, bt,
                time, motion_blur, n);
  *best_t = bt;
  return best;
}

// Occluder compare modes of any_hit (pallas_intersect.py::_anyhit_kernel).
enum AnyHitMode { kModeNone = 0, kModeGrid = 1, kModeBvh = 2 };

// Whether object g at ray parameter t occludes a shadow ray of length
// dist in this mode.
__device__ __forceinline__ bool occludes(float t, float dist, int g, int excl,
                                         int mode) {
  if (mode == kModeGrid) return t < dist;
  if (mode == kModeBvh) return t <= dist + kEpsilon;
  return t < dist && t > 1e-4f && g != excl;
}

// True at the first occluder; shadow rays carry time = 0.
__device__ __forceinline__ bool any_fold(const float* table, const int* types,
                                         int n_obj, const Ray& r, float dist,
                                         int excl, int mode,
                                         bool motion_blur) {
  for (int g = 0; g < n_obj; ++g) {
    const float t = prim_t(__ldg(types + g), r,
                           table + (size_t)g * kRowWidth, 0.0f, motion_blur);
    if (occludes(t, dist, g, excl, mode)) return true;
  }
  return false;
}

// ------------------------------------------------------------ group folds
// A table of n rows that a group fold walks: round(g, G, ...) tests rows
// g + u * G (u < kUnroll) side by side, indices past n testing row n - 1
// again (their results are dropped), so that the kUnroll tests are always
// there to interleave; id(k) is row k's object id, the one an excluded id
// is compared with.

// The packed (O,12) table in insertion order, with its (O,) types (K1,
// K3): a row's id is its index.
struct MixedRows {
  const float* table;
  const int* types;
  int n;

  __device__ __forceinline__ void round(int g, int G, const Ray& r,
                                        float time, bool mb, float* t) const {
    int typ[kUnroll];
    const float* row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = min(g + u * G, n - 1);
      typ[u] = __ldg(types + k);
      row[u] = table + (size_t)k * kRowWidth;
    }
    prim_t_n<true, kUnroll>(typ, row, r, time, mb, t);
  }
  __device__ __forceinline__ int id(int k) const { return k; }
};

// One type run of K2's tables: n rows of kType, 16-byte aligned, spheres
// [cx, cy, cz, r] in 4 floats and the other types in their 12-float rows,
// each row read as the 16-byte loads its test needs; ids: each row's
// object id.  The type is known at compile time, so no test branches on
// it.
template <int kType>
struct TypedRows {
  static constexpr int kWidth = kType == kSphere ? 4 : kRowWidth;
  // 16-byte loads a test reads: sphere 4 floats, triangle 9, plane 4, box 6
  static constexpr int kVecs = kType == kTriangle ? 3 : kType == kBox ? 2 : 1;
  const float* rows;
  const int* ids;
  int n;

  __device__ __forceinline__ void round(int g, int G, const Ray& r,
                                        float time, bool mb, float* t) const {
    float v[kUnroll][4 * kVecs];
    int typ[kUnroll];
    const float* row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = min(g + u * G, n - 1);
      const float4* p =
          reinterpret_cast<const float4*>(rows + (size_t)k * kWidth);
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        const float4 x = __ldg(p + q);
        v[u][4 * q] = x.x;
        v[u][4 * q + 1] = x.y;
        v[u][4 * q + 2] = x.z;
        v[u][4 * q + 3] = x.w;
      }
      typ[u] = kType;
      row[u] = v[u];
    }
    prim_t_n<false, kUnroll>(typ, row, r, time, mb, t);
  }
  __device__ __forceinline__ int id(int k) const { return __ldg(ids + k); }
};

// Folds rows sub, sub + G, ... of `rows` into (bt, best), kUnroll rows a
// round: the least t, and of equal t the least object id, so rows may come
// in any order (K1's type runs) and still give the serial fold's winner
// (strict <, the first in insertion order winning a tie).  The rounds'
// bounds are the same for every thread of the group, and of every group
// of a block, so the warp's groups run them in step with no vote.
template <class Rows>
__device__ __forceinline__ void closest_rounds(const Rows& rows,
                                               const Group& grp,
                                               const Ray& r, float time,
                                               bool mb, float& bt,
                                               int& best) {
  const int G = grp.size;
  for (int b = 0; b < rows.n; b += G * kUnroll) {
    const int g = b + grp.sub;
    float t[kUnroll];
    rows.round(g, G, r, time, mb, t);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = g + u * G;
      // a miss (FLT_MAX) never wins: best is -1 while bt is FLT_MAX
      if (k < rows.n && (t[u] < bt || (t[u] == bt && rows.id(k) < best))) {
        bt = t[u];
        best = rows.id(k);
      }
    }
  }
}

// The closest hit over one or more tables of rows, each lane's fold split
// over its group (every thread of the group must call it): each thread
// folds its share of every table (closest_rounds), then the group reduces
// to the least (t, object id) (group_min), the serial fold's winner.
// Returns its object id or -1, and its t in *t_out.
template <class... Rows>
__device__ __forceinline__ int closest_group(const Group& grp, const Ray& r,
                                             float time, bool mb,
                                             float* t_out,
                                             const Rows&... rows) {
  float bt = kFltMax;
  int best = -1, unused = 0;
  (closest_rounds(rows, grp, r, time, mb, bt, best), ...);
  group_min(grp, bt, best, unused);
  *t_out = bt;
  return best;
}

// Whether one of the rows g + u * G (u < kUnroll) of `rows` occludes the
// shadow ray (time 0).
template <class Rows>
__device__ __forceinline__ bool round_occludes(const Rows& rows, int g, int G,
                                               const Ray& r, float dist,
                                               int excl, int mode, bool mb) {
  float t[kUnroll];
  rows.round(g, G, r, 0.0f, mb, t);
  bool h = false;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    h = h || (g + u * G < rows.n &&
              occludes(t[u], dist, rows.id(g + u * G), excl, mode));
  return h;
}

// Whether a row of `rows` occludes the shadow ray (time 0), the fold split
// over the group (K3's split shadow folds): after each round of G x
// kUnroll rows the group votes, so it stops at the round of the first
// occluder.  Every thread of the group must call it; other groups of the
// warp need not.
template <class Rows>
__device__ __forceinline__ bool any_group(const Rows& rows, const Group& grp,
                                          const Ray& r, float dist, int excl,
                                          int mode, bool mb) {
  const int G = grp.size;
  for (int b = 0; b < rows.n; b += G * kUnroll)
    if (__any_sync(grp.mask, round_occludes(rows, b + grp.sub, G, r, dist,
                                            excl, mode, mb)))
      return true;
  return false;
}

// The same fold with the warp kept together (K2): every working thread of
// the warp (`warp`, a mask that every one of them passes) runs the same
// rounds; a group that has found its occluder (done) sits the rounds out,
// and the warp leaves when every group is done.  One ballot a round gives
// each group its vote.  A group-mask vote in a loop that groups leave at
// different rounds let the warp's groups run apart (measured: PERF.md).
// Returns done, or whether a row occludes.  Every working thread of the
// warp must call it.
template <class Rows>
__device__ __forceinline__ bool any_warp(const Rows& rows, const Group& grp,
                                         unsigned warp, const Ray& r,
                                         float dist, int excl, int mode,
                                         bool mb, bool done) {
  const int G = grp.size;
  for (int b = 0; b < rows.n; b += G * kUnroll) {
    if (__all_sync(warp, done)) break;
    bool h = false;
    if (!done)
      h = round_occludes(rows, b + grp.sub, G, r, dist, excl, mode, mb);
    const unsigned votes = __ballot_sync(warp, h);  // every thread, always
    done = done || (votes & grp.mask) != 0;
  }
  return done;
}

}  // namespace drt
