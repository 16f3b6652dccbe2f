// K4 pt_closest, K5 pt_any_hit and K6 pt_bounce: the GLSL path tracer's
// scene queries and its fused bounce, one bounce a launch or a path's whole
// bounce loop in one launch.
//
// Replaces distributionraytracer_tpu/ops/pallas_pt.py:
//   K4 pt_closest (_closest_kernel over _fold),
//   K5 pt_any_hit (_anyhit_kernel),
//   K6 pt_bounce (_bounce_kernel): closest hit with the winner's material
//      row; point lights with shadow folds; quad lights with no shadow ray
//      and the GGX view-sign quirk; emission; scatter for the four
//      materials; Russian roulette; the gradient sky, or the cubemap miss
//      latched for one texel gather after the last bounce.
// Bound on this card: FP32 issue.  Each lane tests every primitive once
// per closest query and up to once more per point light (rays x primitives
// x (1 + lights) tests; the tests are uncontracted, so each mul/add issues
// alone); memory traffic is the lane's streams in and out.
// K4, redesigned for the H100.  What held the first version back: one
// thread a lane ran a serial chain of uncontracted tests, one primitive
// at a time with scalar loads, and its wrapper stacked seven (R,) columns
// into a (7, R) copy before every launch and transposed the normals
// after.  The design, as K5's:
//   - it reads the callers' (R,3) o and d and (R,) time in place, and
//     writes PTHit's fields in their layouts (hit, t, pos, (R,3) normal,
//     material), so the wrapper launches nothing else;
//   - one thread a lane, every lane (the Pallas kernel has no valid
//     input, and the staged body asks for every lane), 128 a block;
//   - within each type run (hit_world's order: triangles, spheres, moving
//     spheres) a thread tests kClosestU = 2 rows side by side (one, four
//     and no launch bound measured slower), read with 16-byte loads into
//     registers (closest_rounds), and takes each round's results in table
//     order with strict <, so the first of equal t wins;
//   - the winner's normal and material are fetched once, after the fold.
// K5, redesigned for the H100.  What held the first version back: a serial
// chain of up to 105 tests, each ending in a branch that may leave the
// fold, so nothing overlapped one test with the next; scalar row loads;
// and the wrapper stacked eight (R,) columns into an (8, R) copy before
// every launch, which cost as much as the kernel.  The design:
//   - it reads the callers' tensors in place: o and d as (R,3), time as
//     (R,), tmax as (R,) or one value for every lane (null pointer);
//   - one thread a lane, every lane (the Pallas kernel has no valid input,
//     and the staged body asks for every lane), 128 a block;
//   - within each type run a thread tests kU rows side by side, each row
//     read with the 16-byte loads its test needs into registers, and
//     leaves at the round of its first occluder (any_rounds).  Keeping the
//     warp's threads in step (a ballot a round, as K2) cost 5%; a vote on a
//     one-thread mask let them run apart and cost 2.3x (PERF.md);
//   - a missed sphere's IEEE root is skipped (quad_t).
// K6, redesigned for the H100.  What bounds it: the latency of each
// lane's fold, a dependent chain of ~105 uncontracted tests x (1 + point
// lights) with IEEE sqrt and divisions in it, and too few warps to hide
// it (~121 registers a thread: 16 warps an SM).  A launch is latency
// bound, not issue bound: the first version took as long at bounce 3
// with 8% of its paths alive (a warp with one live lane ran the whole
// fold) as at bounce 0 with all of them.  The design (lanes.cuh):
//   - a block of kBounceThreads lanes clears every lane's time in one
//     coalesced pass and compacts its live lanes; warps with none leave;
//   - a block whose live lanes fill its threads (G = 1) runs the serial
//     folds below, whose loops the compiler unrolls itself; a block with
//     fewer splits each live lane's folds over a group of G = 2..32
//     threads, each testing every G-th primitive, kU at a time written so
//     that their arithmetic interleaves (one test at a time was much
//     slower: the chain is the bound); the closest hit is a shuffle
//     reduction (least t, then least index: the serial fold's winner,
//     with the moving sphere's near-root flag), the shadow folds vote
//     after each round and stop at the first occluder's round.  The
//     table's rows come through the read-only cache (a group's threads
//     read different rows; a version that staged the table in shared
//     memory lost to this one once the launch bound of two blocks an SM
//     below ended its spills);
//   - the IEEE root of every missed sphere is skipped: quad_t returns on a
//     negative (or NaN) discriminant before its sqrt and divisions (K4, K5
//     too);
//   - the path tracer's main route runs a path's whole bounce loop in one
//     launch (pt_bounce_kernel_loop): a block keeps its lanes' 20 state
//     rows in shared memory (~20 KB; two blocks an SM, as before), and
//     before each bounce compacts its live lanes again, regroups, and runs
//     the same body (bounce_lane) on that bounce's uniforms, read in place
//     from the stacked tensors; it leaves when no lane is live.  A launch a
//     bounce had the host pack each bounce's uniforms and launch 10 kernels
//     a tile, ~100 us of host work against ~33 us of kernel, and every
//     bounce's state went to memory and back.  The single-bounce
//     pt_bounce_kernel runs the same body on a (20, R) state in global
//     memory.  PERF.md records what each point bought on the card.
// The winner's normal and material are fetched once, after the fold.
// Skips that are exact:
//   - K6 dead lanes (alive == 0) pass every state stream through unchanged
//     in the Pallas kernel, so they only clear their time;
//   - shadow folds stop at the first occluder (the fold is an OR) and run
//     only for hit lanes facing the light (the contribution is gated by
//     both);
//   - scatter and roulette run only for hit lanes (their results are gated
//     by live_hit).
// The geometric tests (triangle, sphere, moving sphere) are evaluated
// uncontracted (__f*_rn) in the plain version's operation order: the
// sphere discriminant cancels catastrophically for small distant spheres,
// and a contracted multiply-add there moves t and the normal visibly.  The
// shading math keeps FMA contraction.  No --use_fast_math.
//
// Layouts (all contiguous f32 unless noted):
//   table (K,12) rows: tri [v0, e1, e2, 0]; sphere [c, r, 0...];
//     moving sphere [c0, c1-c0, r, 0...]; T triangles, then S spheres,
//     then M moving spheres;
//   mats (K,) i32; mrow (K,16) [type, albedo3, spec3, emissive3, rough,
//     refidx, refract3, stripe];
//   plights (Lp,6) [pos, color]; qlights (Lq,12) [pos, e1, e2, color];
//   K4 o, d (R,3), time (R,) -> hit (R,) u8, t (R,), pos (R,3), normal
//      (R,3), material (R,) i32; the table 16-byte aligned;
//   K5 o, d (R,3), time (R,), tmax (R,) or a scalar -> occ (R,) u8; the
//      table 16-byte aligned;
//   K6 state (20,R) ox oy oz dx dy dz time col3 thr3 alive mw3 md3, read
//      and written in place; uni (8+2*Lq,R) uch u3a3 u3b3 urr uq...;
//   looped K6 o, d (R,3), time (R,), the stacked uniforms uq (B,R,2q),
//      uch (B,R), u3a, u3b (B,R,3), urr (B,R) through their strides ->
//      col (R,3), and mw, md (R,3) for cubemap skies;
// Each launch function returns cudaGetLastError().

#include <cfloat>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 128;               // K4, K5: threads a block
constexpr int kBounceThreads = drt::kLaneBlock;  // K6: threads, and lanes
constexpr int kStateRows = 20;  // K6: rows of a lane's state
constexpr int kU = drt::kUnroll;  // K5, K6: rows a thread tests side by side
constexpr int kClosestU = 2;      // K4: rows a thread tests side by side
constexpr int kRow = 12;
constexpr int kMat = 16;
constexpr float kEps = 1e-3f;  // common.glsl:7
constexpr float kBig = 1e4f;   // hit_world's default tmax
constexpr float kMissT = FLT_MAX;
constexpr float kPi = 3.14159265358979f;
enum MatType { kDiffuse = 0, kMetal = 1, kDielectric = 2, kPlastic = 3 };

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// A row field through the read-only cache (G), or from a row the caller
// holds in registers (K5's rounds).
template <bool G = true>
__device__ __forceinline__ float ld(const float* p, int i) {
  if constexpr (G) return __ldg(p + i);
  return p[i];
}
// One IEEE rounding per operation, never contracted into an FMA.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// hit_triangle (common.glsl:418-447) in hit_world's formulation.
template <bool G = true>
__device__ __forceinline__ float tri_t(const Ray& r, const float* row) {
  const float v0x = ld<G>(row, 0), v0y = ld<G>(row, 1), v0z = ld<G>(row, 2);
  const float e1x = ld<G>(row, 3), e1y = ld<G>(row, 4), e1z = ld<G>(row, 5);
  const float e2x = ld<G>(row, 6), e2y = ld<G>(row, 7), e2z = ld<G>(row, 8);
  const float hx = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const float hy = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const float hz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const float a = dot3(e1x, e1y, e1z, hx, hy, hz);
  const float f = __fdiv_rn(1.0f, a != 0.0f ? a : 1.0f);
  const float sx = sub(r.ox, v0x), sy = sub(r.oy, v0y), sz = sub(r.oz, v0z);
  const float u = mul(f, dot3(sx, sy, sz, hx, hy, hz));
  const float qx = sub(mul(sy, e1z), mul(sz, e1y));
  const float qy = sub(mul(sz, e1x), mul(sx, e1z));
  const float qz = sub(mul(sx, e1y), mul(sy, e1x));
  const float v = mul(f, dot3(qx, qy, qz, r.dx, r.dy, r.dz));
  const float t = mul(f, dot3(e2x, e2y, e2z, qx, qy, qz));
  const bool ok = a != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                  add(u, v) <= 1.0f && t > kEps;
  return ok ? t : kMissT;
}

// The two roots of a*t^2 + b*t + c with disc = b^2 - 4ac; t1 > EPS picks
// the near root, else the far one.  A miss (NaN included) needs no root:
// the IEEE sqrt and the two divisions are most of a test's instructions,
// and most tests miss (near_root only matters for a winner).
__device__ __forceinline__ float quad_t(float a, float b, float disc,
                                        bool* near_root) {
  if (!(disc >= 0.0f)) {
    *near_root = false;
    return kMissT;
  }
  const float sq = disc > 0.0f ? __fsqrt_rn(disc) : 0.0f;
  const float t1 = __fdiv_rn(sub(-b, sq), mul(2.0f, a));
  const float t2 = __fdiv_rn(add(-b, sq), mul(2.0f, a));
  *near_root = t1 > kEps;
  const float t = *near_root ? t1 : t2;
  return (disc >= 0.0f && t > kEps) ? t : kMissT;
}

// hit_sphere (common.glsl:513-549): b and the discriminant; a = d.d.
template <bool G = true>
__device__ __forceinline__ float sph_disc(const Ray& r, const float* row,
                                          float a_dd, float* b_out) {
  const float rad = ld<G>(row, 3);
  const float ocx = sub(r.ox, ld<G>(row, 0)), ocy = sub(r.oy, ld<G>(row, 1)),
              ocz = sub(r.oz, ld<G>(row, 2));
  const float b = mul(2.0f, dot3(ocx, ocy, ocz, r.dx, r.dy, r.dz));
  const float c = sub(dot3(ocx, ocy, ocz, ocx, ocy, ocz), mul(rad, rad));
  *b_out = b;
  return sub(mul(b, b), mul(mul(4.0f, a_dd), c));
}

__device__ __forceinline__ float sph_t(const Ray& r, const float* row,
                                       float a_dd) {
  float b;
  const float disc = sph_disc(r, row, a_dd, &b);
  bool near_root;
  return quad_t(a_dd, b, disc, &near_root);
}

// hit_movingSphere (common.glsl:551-605): the shader's quadratic in
// d1 = center(time+EPS) - center(time) = (c1-c0)*EPS; returns its
// discriminant, with a and b.
template <bool G = true>
__device__ __forceinline__ float msph_disc(const Ray& r, const float* row,
                                           float time, float a_dd,
                                           float* a_out, float* b_out) {
  const float bx = ld<G>(row, 3), by = ld<G>(row, 4), bz = ld<G>(row, 5);
  const float rad = ld<G>(row, 6);
  const float c0x = add(ld<G>(row, 0), mul(bx, time));
  const float c0y = add(ld<G>(row, 1), mul(by, time));
  const float c0z = add(ld<G>(row, 2), mul(bz, time));
  const float d1x = mul(bx, kEps), d1y = mul(by, kEps), d1z = mul(bz, kEps);
  const float ocx = sub(r.ox, c0x), ocy = sub(r.oy, c0y),
              ocz = sub(r.oz, c0z);
  const float dd1 = dot3(r.dx, r.dy, r.dz, d1x, d1y, d1z);
  const float a = sub(a_dd, mul(dd1, dd1));
  const float oc_d = dot3(ocx, ocy, ocz, r.dx, r.dy, r.dz);
  const float oc_d1 = dot3(ocx, ocy, ocz, d1x, d1y, d1z);
  const float b = mul(2.0f, sub(oc_d, mul(oc_d1, dd1)));
  const float c = sub(sub(dot3(ocx, ocy, ocz, ocx, ocy, ocz),
                          mul(oc_d1, oc_d1)), mul(rad, rad));
  *a_out = a;
  *b_out = b;
  return sub(mul(b, b), mul(mul(4.0f, a), c));
}

// `outside` is the near-root flag that selects the normal's centre.
__device__ __forceinline__ float msph_t(const Ray& r, const float* row,
                                        float time, float a_dd,
                                        bool* outside) {
  float a, b;
  const float disc = msph_disc(r, row, time, a_dd, &a, &b);
  return quad_t(a, b, disc, outside);
}

// U tests of one ray against rows row[u] of one type, written so that
// their arithmetic can interleave (a lane's fold is a dependent chain, and
// a warp has few others to hide its latency behind): for (moving)
// spheres every discriminant first, then the roots of those that are not
// misses.  out[u]: a moving sphere's near-root flag.  G as in ld.
template <int U, bool G = true>
__device__ __forceinline__ void tri_t_n(const Ray& r, const float* const* row,
                                        float* t) {
#pragma unroll
  for (int u = 0; u < U; ++u) t[u] = tri_t<G>(r, row[u]);
}

template <int U, bool G = true>
__device__ __forceinline__ void sph_t_n(const Ray& r, const float* const* row,
                                        float a_dd, float* t) {
  float b[U], disc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) disc[u] = sph_disc<G>(r, row[u], a_dd, &b[u]);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    bool near_root;
    t[u] = quad_t(a_dd, b[u], disc[u], &near_root);
  }
}

template <int U, bool G = true>
__device__ __forceinline__ void msph_t_n(const Ray& r,
                                         const float* const* row, float time,
                                         float a_dd, float* t, bool* out) {
  float a[U], b[U], disc[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    disc[u] = msph_disc<G>(r, row[u], time, a_dd, &a[u], &b[u]);
#pragma unroll
  for (int u = 0; u < U; ++u) t[u] = quad_t(a[u], b[u], disc[u], &out[u]);
}

// (x, y, z) / |(x, y, z)|, a zero vector staying zero (safe_normalize).
__device__ __forceinline__ void unit_rn(float x, float y, float z, float* n) {
  const float l2 = dot3(x, y, z, x, y, z);
  const float len = l2 > 1e-20f ? __fsqrt_rn(l2) : 1.0f;
  n[0] = l2 > 1e-20f ? __fdiv_rn(x, len) : 0.0f;
  n[1] = l2 > 1e-20f ? __fdiv_rn(y, len) : 0.0f;
  n[2] = l2 > 1e-20f ? __fdiv_rn(z, len) : 0.0f;
}

// The winner's unit normal at t (zero when best < 0), as hit_world
// computes it; out is a moving sphere's near-root flag.
__device__ void winner_normal(const float* __restrict__ table, int T, int S,
                              const Ray& r, float time, float bt, int best,
                              bool best_out, float* n) {
  n[0] = n[1] = n[2] = 0.0f;
  if (best < 0) return;
  const float* row = table + (size_t)best * kRow;
  if (best < T) {
    const float e1x = ld(row, 3), e1y = ld(row, 4), e1z = ld(row, 5);
    const float e2x = ld(row, 6), e2y = ld(row, 7), e2z = ld(row, 8);
    unit_rn(sub(mul(e1y, e2z), mul(e1z, e2y)),
            sub(mul(e1z, e2x), mul(e1x, e2z)),
            sub(mul(e1x, e2y), mul(e1y, e2x)), n);
    return;
  }
  const float px = add(r.ox, mul(r.dx, bt));
  const float py = add(r.oy, mul(r.dy, bt));
  const float pz = add(r.oz, mul(r.dz, bt));
  if (best < T + S) {
    unit_rn(sub(px, ld(row, 0)), sub(py, ld(row, 1)), sub(pz, ld(row, 2)),
            n);
    if (ld(row, 3) < 0.0f) {  // negative radius flips (common.glsl:545)
      n[0] = -n[0]; n[1] = -n[1]; n[2] = -n[2];
    }
    return;
  }
  // the moving sphere's centre at `time`, moved by d1 for the far root
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = add(ld(row, k), mul(ld(row, 3 + k), time));
    if (!best_out) c[k] = add(c[k], mul(ld(row, 3 + k), kEps));
  }
  unit_rn(sub(px, c[0]), sub(py, c[1]), sub(pz, c[2]), n);
}

// Closest hit over all primitives (strict <, table order).  Returns the
// winner's index or -1, its t (kBig when none) and its unit normal (zero
// when none), as hit_world computes them.
__device__ int closest_fold(const float* __restrict__ table, int T, int S,
                            int M, const Ray& r, float time, float* t_out,
                            float* n) {
  const float a_dd = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  float bt = kBig;
  int best = -1;
  bool best_out = false;
  for (int g = 0; g < T; ++g) {
    const float t = tri_t(r, table + (size_t)g * kRow);
    if (t < bt) { bt = t; best = g; }
  }
  for (int g = T; g < T + S; ++g) {
    const float t = sph_t(r, table + (size_t)g * kRow, a_dd);
    if (t < bt) { bt = t; best = g; }
  }
  for (int g = T + S; g < T + S + M; ++g) {
    bool out;
    const float t = msph_t(r, table + (size_t)g * kRow, time, a_dd, &out);
    if (t < bt) { bt = t; best = g; best_out = out; }
  }
  *t_out = bt;
  winner_normal(table, T, S, r, time, bt, best, best_out, n);
  return best;
}

// True at the first primitive with EPS < t < tmax.
__device__ bool any_fold(const float* __restrict__ table, int T, int S, int M,
                         const Ray& r, float time, float tmax) {
  const float a_dd = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  for (int g = 0; g < T; ++g)
    if (tri_t(r, table + (size_t)g * kRow) < tmax) return true;
  for (int g = T; g < T + S; ++g)
    if (sph_t(r, table + (size_t)g * kRow, a_dd) < tmax) return true;
  for (int g = T + S; g < T + S + M; ++g) {
    bool out;
    if (msph_t(r, table + (size_t)g * kRow, time, a_dd, &out) < tmax)
      return true;
  }
  return false;
}

// --------------------------------------------------------------- K6 helpers
__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-24f));
  x *= inv; y *= inv; z *= inv;
}

__device__ __forceinline__ float pow5(float c) {
  return c * ((c * c) * (c * c));
}

__device__ __forceinline__ float fresnel1(float cos_t, float f0) {
  return f0 + (1.0f - f0) * pow5(fmaxf(1.0f - cos_t, 0.0f));
}

struct Material {
  float typ, alb[3], spec[3], emis[3], rough, refidx, refract[3];
};

// One light's Blinn-Phong / GGX contribution added to col (P3D_RT.glsl:
// 496-520, 550-575); v_ggx is the (quirked) GGX view, v the Blinn view.
__device__ __forceinline__ void light_add(
    float* col, const float* thr, const Material& m, const float* n,
    const float* l, const float* v, const float* v_ggx, const float* lcol) {
  const float ndl = fmaxf(n[0] * l[0] + n[1] * l[1] + n[2] * l[2], 0.0f);
  float hbx = l[0] + v[0], hby = l[1] + v[1], hbz = l[2] + v[2];
  norm3(hbx, hby, hbz);
  const float r2 = m.rough * m.rough;
  const float r4 = r2 * r2;
  const float shin = 8.0f / (r4 + kEps) - 2.0f;
  const float spec_b =
      powf(fmaxf(n[0] * hbx + n[1] * hby + n[2] * hbz, 0.0f), shin);
  float hgx = hbx, hgy = hby, hgz = hbz;
  if (v_ggx != v) {
    hgx = l[0] + v_ggx[0]; hgy = l[1] + v_ggx[1]; hgz = l[2] + v_ggx[2];
    norm3(hgx, hgy, hgz);
  }
  const float nov =
      fmaxf(n[0] * v_ggx[0] + n[1] * v_ggx[1] + n[2] * v_ggx[2], 0.0f);
  const float ndh = fmaxf(n[0] * hgx + n[1] * hgy + n[2] * hgz, 0.0f);
  const float cos_vh =
      fmaxf(v_ggx[0] * hgx + v_ggx[1] * hgy + v_ggx[2] * hgz, 0.0f);
  const float bb = ndh * ndh * (r4 - 1.0f) + 1.0f;
  const float dg = r4 / (kPi * bb * bb + kEps);
  const float rr = 0.25f * m.rough;
  const float kk = rr * rr / 2.0f;
  const float g1l = fmaxf(ndl, 0.0f) / (ndl * (1.0f - kk) + kk + kEps);
  const float g1v = fmaxf(nov, 0.0f) / (nov * (1.0f - kk) + kk + kEps);
  const float DG = (dg * g1l * g1v) / (4.0f * nov * ndl + kEps);
  const bool is_gm = m.typ == kMetal || m.typ == kPlastic;
  const bool is_pla = m.typ == kPlastic;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ks_f = fresnel1(fmaxf(nov, 0.0f), m.spec[k]);
    const float spec_k =
        is_gm ? DG * fresnel1(cos_vh, m.spec[k]) : m.spec[k] * spec_b;
    const float diff_k =
        is_pla ? (1.0f - ks_f) * m.alb[k] / kPi : m.alb[k] * ndl;
    col[k] = col[k] + (diff_k + spec_k) * lcol[k] * ndl * thr[k];
  }
}

// randomInUnitSphere from 3 uniforms (common.glsl:102-108)
__device__ __forceinline__ void unit_sphere(float u0, float u1, float u2,
                                            float* s3) {
  const float h0 = u0 * 2.0f - 1.0f;
  const float phi = u1 * 6.28318530718f;
  const float r3 = powf(fmaxf(u2, 0.0f), 1.0f / 3.0f);
  const float s = sqrtf(fmaxf(1.0f - h0 * h0, 0.0f));
  s3[0] = r3 * s * sinf(phi);
  s3[1] = r3 * s * cosf(phi);
  s3[2] = r3 * h0;
}

// jnp.mod(x, 1.0): the remainder with the divisor's sign.
__device__ __forceinline__ float mod1(float x) {
  float r = fmodf(x, 1.0f);
  return (r != 0.0f && r < 0.0f) ? r + 1.0f : r;
}

// The rows of one round of a thread: g[u] = g + u * G (u < kU) of the
// type range ending at hi; indices past hi test row hi - 1 again (their
// results are dropped), so that the kU tests are always there to
// interleave.
__device__ __forceinline__ void round_rows(const float* table, int hi, int g,
                                           int G, const float** row) {
#pragma unroll
  for (int u = 0; u < kU; ++u)
    row[u] = table + (size_t)min(g + u * G, hi - 1) * kRow;
}

// Rows g + u (u < U) of the type range ending at hi, as round_rows
// picks them for one thread, read into registers with kVecs 16-byte loads
// a row (a test reads the row's first 9, 4 or 7 floats: triangle 3,
// sphere 1, moving sphere 2); row[u] = v[u].
template <int kVecs, int U = kU>
__device__ __forceinline__ void round_regs(const float* table, int hi, int g,
                                           float (*v)[kRow],
                                           const float** row) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4* p = reinterpret_cast<const float4*>(
        table + (size_t)min(g + u, hi - 1) * kRow);
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const float4 x = __ldg(p + q);
      v[u][4 * q] = x.x;
      v[u][4 * q + 1] = x.y;
      v[u][4 * q + 2] = x.z;
      v[u][4 * q + 3] = x.w;
    }
    row[u] = v[u];
  }
}

// closest_fold split over the group: each thread folds rows sub, sub + G,
// ... of each type range in order, kU at a time (strict <), then the
// group reduces to the serial fold's winner (least t, then least index).
// Returns its index or -1, its t and its near-root flag.
__device__ __forceinline__ int closest_group(const float* __restrict__ table,
                                             int T, int S, int K,
                                             const drt::Group& grp,
                                             const Ray& r, float time,
                                             float* t_out, bool* out_flag) {
  const float a_dd = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  const int G = grp.size, TS = T + S;
  float bt = kBig;
  int best = -1, bout = 0;
  const float* row[kU];
  float t[kU];
  for (int g = grp.sub; g < T; g += G * kU) {
    round_rows(table, T, g, G, row);
    tri_t_n<kU>(r, row, t);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (g + u * G < T && t[u] < bt) { bt = t[u]; best = g + u * G; }
  }
  for (int g = T + grp.sub; g < TS; g += G * kU) {
    round_rows(table, TS, g, G, row);
    sph_t_n<kU>(r, row, a_dd, t);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (g + u * G < TS && t[u] < bt) { bt = t[u]; best = g + u * G; }
  }
  for (int g = TS + grp.sub; g < K; g += G * kU) {
    bool out[kU];
    round_rows(table, K, g, G, row);
    msph_t_n<kU>(r, row, time, a_dd, t, out);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (g + u * G < K && t[u] < bt) {
        bt = t[u];
        best = g + u * G;
        bout = out[u];
      }
  }
  drt::group_min(grp, bt, best, bout);
  *t_out = bt;
  *out_flag = bout != 0;
  return best;
}

// Whether any of a round's kU tests (rows g + u * G below hi) is closer
// than tmax.
__device__ __forceinline__ bool round_hit(const float* t, int g, int G,
                                          int hi, float tmax) {
  bool h = false;
#pragma unroll
  for (int u = 0; u < kU; ++u) h = h || (g + u * G < hi && t[u] < tmax);
  return h;
}

// any_fold split over the group: after each round of G x kU primitives
// the group votes, so it stops at the round of the first occluder.
__device__ __forceinline__ bool any_group(const float* __restrict__ table,
                                          int T, int S, int K,
                                          const drt::Group& grp,
                                          const Ray& r, float tmax) {
  const float a_dd = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  const int G = grp.size, TS = T + S;
  const float* row[kU];
  float t[kU];
  for (int b = 0; b < T; b += G * kU) {
    round_rows(table, T, b + grp.sub, G, row);
    tri_t_n<kU>(r, row, t);
    if (__any_sync(grp.mask, round_hit(t, b + grp.sub, G, T, tmax)))
      return true;
  }
  for (int b = T; b < TS; b += G * kU) {
    round_rows(table, TS, b + grp.sub, G, row);
    sph_t_n<kU>(r, row, a_dd, t);
    if (__any_sync(grp.mask, round_hit(t, b + grp.sub, G, TS, tmax)))
      return true;
  }
  for (int b = TS; b < K; b += G * kU) {
    bool out[kU];
    round_rows(table, K, b + grp.sub, G, row);
    msph_t_n<kU>(r, row, 0.0f, a_dd, t, out);
    if (__any_sync(grp.mask, round_hit(t, b + grp.sub, G, K, tmax)))
      return true;
  }
  return false;
}

// K5's fold: one thread a lane, in rounds of kU rows of each type range,
// read into registers (round_regs); it leaves at the round of its first
// occluder.
__device__ __forceinline__ bool any_rounds(const float* __restrict__ table,
                                           int T, int S, int K, const Ray& r,
                                           float time, float tmax) {
  const float a_dd = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  const int TS = T + S;
  const float* row[kU];
  float v[kU][kRow];
  float t[kU];
  bool done = false;
  for (int b = 0; b < T && !done; b += kU) {
    round_regs<3>(table, T, b, v, row);
    tri_t_n<kU, false>(r, row, t);
    done = round_hit(t, b, 1, T, tmax);
  }
  for (int b = T; b < TS && !done; b += kU) {
    round_regs<1>(table, TS, b, v, row);
    sph_t_n<kU, false>(r, row, a_dd, t);
    done = round_hit(t, b, 1, TS, tmax);
  }
  for (int b = TS; b < K && !done; b += kU) {
    bool out[kU];
    round_regs<2>(table, K, b, v, row);
    msph_t_n<kU, false>(r, row, time, a_dd, t, out);
    done = round_hit(t, b, 1, K, tmax);
  }
  return done;
}

// K4's fold: one thread a lane, in rounds of kClosestU rows of each type
// range read into registers (round_regs) and tested side by side, each
// round's results taken in table order with strict <, so the first of
// equal t wins, as in the serial fold.  Returns the winner's index or
// -1, its t (kBig when none) and a moving sphere's near-root flag.
__device__ __forceinline__ int closest_rounds(const float* __restrict__ table,
                                              int T, int S, int K,
                                              const Ray& r, float time,
                                              float* t_out, bool* out_flag) {
  const float a_dd = dot3(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz);
  const int TS = T + S;
  const float* row[kClosestU];
  float v[kClosestU][kRow];
  float t[kClosestU];
  float bt = kBig;
  int best = -1;
  bool bout = false;
  for (int b = 0; b < T; b += kClosestU) {
    round_regs<3, kClosestU>(table, T, b, v, row);
    tri_t_n<kClosestU, false>(r, row, t);
#pragma unroll
    for (int u = 0; u < kClosestU; ++u)
      if (b + u < T && t[u] < bt) { bt = t[u]; best = b + u; }
  }
  for (int b = T; b < TS; b += kClosestU) {
    round_regs<1, kClosestU>(table, TS, b, v, row);
    sph_t_n<kClosestU, false>(r, row, a_dd, t);
#pragma unroll
    for (int u = 0; u < kClosestU; ++u)
      if (b + u < TS && t[u] < bt) { bt = t[u]; best = b + u; }
  }
  for (int b = TS; b < K; b += kClosestU) {
    bool out[kClosestU];
    round_regs<2, kClosestU>(table, K, b, v, row);
    msph_t_n<kClosestU, false>(r, row, time, a_dd, t, out);
#pragma unroll
    for (int u = 0; u < kClosestU; ++u)
      if (b + u < K && t[u] < bt) {
        bt = t[u];
        best = b + u;
        bout = out[u];
      }
  }
  *t_out = bt;
  *out_flag = bout;
  return best;
}

// K4: every lane's closest hit on its own thread, in rounds; the winner's
// normal and material once, after the fold.  Writes PTHit's fields in
// its layouts: hit, t, pos = o + d * (hit ? t : 1), normal, material.
__global__ void __launch_bounds__(kThreads) pt_closest_kernel(
    const float* __restrict__ table, const int* __restrict__ mats, int T,
    int S, int M, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ time, int n, unsigned char* __restrict__ hit,
    float* __restrict__ t_out, float* __restrict__ pos,
    float* __restrict__ normal, int* __restrict__ mat) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Ray r{o[3 * i], o[3 * i + 1], o[3 * i + 2],
              d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const float tm = time[i];
  float bt, nrm[3];
  bool bout;
  const int g = closest_rounds(table, T, S, T + S + M, r, tm, &bt, &bout);
  winner_normal(table, T, S, r, tm, bt, g, bout, nrm);
  const float s = g >= 0 ? bt : 1.0f;
  hit[i] = g >= 0 ? 1 : 0;
  t_out[i] = bt;
  pos[3 * i] = add(r.ox, mul(r.dx, s));
  pos[3 * i + 1] = add(r.oy, mul(r.dy, s));
  pos[3 * i + 2] = add(r.oz, mul(r.dz, s));
#pragma unroll
  for (int k = 0; k < 3; ++k) normal[3 * i + k] = nrm[k];
  mat[i] = g >= 0 ? __ldg(mats + g) : 0;
}

// K5: every lane's shadow fold on its own thread, in rounds.
__global__ void __launch_bounds__(kThreads) pt_any_hit_kernel(
    const float* __restrict__ table, int T, int S, int M,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ time, const float* __restrict__ tmax,
    float tmax_all, int n, unsigned char* __restrict__ occ) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Ray r{o[3 * i], o[3 * i + 1], o[3 * i + 2],
              d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const float tx = tmax != nullptr ? tmax[i] : tmax_all;
  occ[i] = any_rounds(table, T, S, T + S + M, r, time[i], tx) ? 1 : 0;
}

// K6's state of one lane: row k at p[k * stride], in the callers' (20, R)
// tensor (the single-bounce launch) or in a block's (20, kBounceThreads)
// rows in shared memory (the looped launch).
struct StateRows {
  float* p;
  size_t stride;
  __device__ __forceinline__ float& operator[](int k) const {
    return p[k * stride];
  }
};

// One lane's uniforms of one bounce: the branch choice ch, the two
// direction samples a(0..2) and b(0..2), the roulette's rr, and quad light
// j's jitter q(2j), q(2j + 1).  StreamUniforms reads them from the
// (8 + 2 * n_ql, R) streams of the single-bounce launch.
struct StreamUniforms {
  const float* p;  // the lane's column
  size_t stride;   // R
  __device__ __forceinline__ float ch() const { return p[0]; }
  __device__ __forceinline__ float a(int k) const {
    return p[(1 + k) * stride];
  }
  __device__ __forceinline__ float b(int k) const {
    return p[(4 + k) * stride];
  }
  __device__ __forceinline__ float rr() const { return p[7 * stride]; }
  __device__ __forceinline__ float q(int k) const {
    return p[(8 + k) * stride];
  }
};

// The looped launch's uniforms: BounceUniforms' stacked tensors uq
// (B,R,2q), uch (B,R), u3a and u3b (B,R,3) and urr (B,R), in that order,
// each read in place through its bounce and lane strides (in elements; a
// vector's components adjacent).
struct BounceUniforms {
  const float* p[5];
  long long sb[5], sr[5];
};

struct StackedUniforms {
  const BounceUniforms& u;
  int bounce;
  long long lane;
  __device__ __forceinline__ float at(int x, int k) const {
    return __ldg(u.p[x] + bounce * u.sb[x] + lane * u.sr[x] + k);
  }
  __device__ __forceinline__ float ch() const { return at(1, 0); }
  __device__ __forceinline__ float a(int k) const { return at(2, k); }
  __device__ __forceinline__ float b(int k) const { return at(3, k); }
  __device__ __forceinline__ float rr() const { return at(4, 0); }
  __device__ __forceinline__ float q(int k) const { return at(0, k); }
};

// K6's body: one bounce of one live lane after the block's compaction
// (closest hit, lights and shadow folds, scatter, roulette), its state's
// rows updated in place.  The lane's group of grp.size threads runs it
// together; a return ends the thread's bounce.
template <class Uni>
__device__ __forceinline__ void bounce_lane(
    const float* __restrict__ table, const float* __restrict__ mrow, int T,
    int S, int M, const float* __restrict__ plights, int n_pl,
    const float* __restrict__ qlights, int n_ql, const drt::Group& grp,
    const StateRows& st, float time, const Uni& uni, int rr, int grad_sky) {
  // A block whose live lanes fill its threads (G = 1) runs the serial
  // folds, whose loops the compiler unrolls itself; the others split
  // theirs over their groups.
  const bool serial = grp.size == 1;
  const int K = T + S + M;
  const bool writer = grp.sub == 0;

  const Ray r{st[0], st[1], st[2], st[3], st[4], st[5]};
  float col[3] = {st[7], st[8], st[9]};
  float thr[3] = {st[10], st[11], st[12]};

  // ---- closest hit, the winner's normal ----
  float t_hit, nrm[3];
  bool best_out;
  int g;
  if (serial) {
    g = closest_fold(table, T, S, M, r, time, &t_hit, nrm);
  } else {
    g = closest_group(table, T, S, K, grp, r, time, &t_hit, &best_out);
    winner_normal(table, T, S, r, time, t_hit, g, best_out, nrm);
  }
  if (g < 0) {
    if (!writer) return;
    // miss (P3D_RT.glsl:659-672): the path ends here
    if (grad_sky) {
      const float tsky = fminf(fmaxf(0.8f * (r.dy + 1.0f), 0.0f), 1.0f);
      const float sky[3] = {1.0f - tsky + tsky * 0.5f,
                            1.0f - tsky + tsky * 0.7f,
                            1.0f - tsky + tsky * 1.0f};
#pragma unroll
      for (int k = 0; k < 3; ++k) st[7 + k] = col[k] + thr[k] * sky[k];
    } else {
      // latch (throughput, direction) for the cubemap gather
#pragma unroll
      for (int k = 0; k < 3; ++k) st[14 + k] = thr[k];
      st[17] = r.dx;
      st[18] = r.dy;
      st[19] = r.dz;
    }
    st[13] = 0.0f;
    return;
  }

  const float* mr = mrow + (size_t)g * kMat;
  Material m;
  m.typ = ld(mr, 0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m.alb[k] = ld(mr, 1 + k);
    m.spec[k] = ld(mr, 4 + k);
    m.emis[k] = ld(mr, 7 + k);
    m.refract[k] = ld(mr, 12 + k);
  }
  m.rough = ld(mr, 10);
  m.refidx = ld(mr, 11);
  float nv[3] = {nrm[0], nrm[1], nrm[2]};
  norm3(nv[0], nv[1], nv[2]);
  const float p[3] = {r.ox + r.dx * t_hit, r.oy + r.dy * t_hit,
                      r.oz + r.dz * t_hit};
  if (ld(mr, 15) > 0.5f) {  // striped background shade (P3D_RT.glsl:149)
    const float shade = floorf(mod1(p[0]) * 2.0f);
    m.alb[0] = m.alb[1] = m.alb[2] = shade;
  }

  if (m.emis[0] != 0.0f || m.emis[1] != 0.0f || m.emis[2] != 0.0f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) col[k] = col[k] + m.emis[k] * thr[k];
  }

  float v[3] = {r.dx, r.dy, r.dz};
  norm3(v[0], v[1], v[2]);
  v[0] = -v[0]; v[1] = -v[1]; v[2] = -v[2];  // viewDir (P3D_RT.glsl:526)

  // ---- point lights with shadow folds (time 0) ----
  for (int j = 0; j < n_pl; ++j) {
    const float* L = plights + (size_t)j * 6;
    float l[3] = {ld(L, 0) - p[0], ld(L, 1) - p[1], ld(L, 2) - p[2]};
    const float dist =
        sqrtf(fmaxf(l[0] * l[0] + l[1] * l[1] + l[2] * l[2], 1e-24f));
    l[0] = l[0] / dist; l[1] = l[1] / dist; l[2] = l[2] / dist;
    const bool facing = nv[0] * l[0] + nv[1] * l[1] + nv[2] * l[2] > 0.0f;
    const Ray s{p[0] + nv[0] * kEps, p[1] + nv[1] * kEps,
                p[2] + nv[2] * kEps, l[0], l[1], l[2]};
    if (!facing || (serial ? any_fold(table, T, S, M, s, 0.0f, dist - 1e-3f)
                           : any_group(table, T, S, K, grp, s,
                                       dist - 1e-3f)))
      continue;
    const float lcol[3] = {ld(L, 3), ld(L, 4), ld(L, 5)};
    light_add(col, thr, m, nv, l, v, v, lcol);
  }

  // ---- quad lights: jittered point, NO shadow ray, and the GGX view
  // sign quirk: BRDF_GGX receives -viewDir = the raw ray direction while
  // Blinn-H keeps +viewDir (P3D_RT.glsl:483-523) ----
  const float gview[3] = {-v[0], -v[1], -v[2]};
  for (int j = 0; j < n_ql; ++j) {
    const float* Q = qlights + (size_t)j * 12;
    const float u1 = uni.q(2 * j);
    const float u2 = uni.q(2 * j + 1);
    float l[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      l[k] = ld(Q, k) + ld(Q, 3 + k) * u1 + ld(Q, 6 + k) * u2 - p[k];
    norm3(l[0], l[1], l[2]);
    if (!(nv[0] * l[0] + nv[1] * l[1] + nv[2] * l[2] > 0.0f)) continue;
    const float lcol[3] = {ld(Q, 9), ld(Q, 10), ld(Q, 11)};
    light_add(col, thr, m, nv, l, v, gview, lcol);
  }

  // ---- scatter (common.glsl:300-407) ----
  const float uch = uni.ch();
  const bool outside = (r.dx * nv[0] + r.dy * nv[1] + r.dz * nv[2]) < 0.0f;
  const float sgn = outside ? 1.0f : -1.0f;
  const float Nn[3] = {nv[0] * sgn, nv[1] * sgn, nv[2] * sgn};
  float ua[3], sb[3];
  unit_sphere(uni.a(0), uni.a(1), uni.a(2), ua);
  norm3(ua[0], ua[1], ua[2]);
  unit_sphere(uni.b(0), uni.b(1), uni.b(2), sb);

  const bool is_dif = m.typ == kDiffuse, is_met = m.typ == kMetal;
  const bool is_die = m.typ == kDielectric;
  // METAL: reflect + rough fuzz (also the specular lobes below)
  const float ddn = r.dx * Nn[0] + r.dy * Nn[1] + r.dz * Nn[2];
  float md[3] = {r.dx - 2.0f * ddn * Nn[0] + sb[0] * m.rough,
                 r.dy - 2.0f * ddn * Nn[1] + sb[1] * m.rough,
                 r.dz - 2.0f * ddn * Nn[2] + sb[2] * m.rough};
  norm3(md[0], md[1], md[2]);
  const bool ok_met = (md[0] * Nn[0] + md[1] * Nn[1] + md[2] * Nn[2]) > 0.0f;
  const bool ok = !is_met || ok_met;

  float new_d[3], atten[3];
  bool refract_dir = false;
  if (is_dif) {
    // DIFFUSE: dir = N + unit vector, unnormalized
#pragma unroll
    for (int k = 0; k < 3; ++k) new_d[k] = Nn[k] + ua[k];
    const float ndd = fmaxf(
        Nn[0] * new_d[0] + Nn[1] * new_d[1] + Nn[2] * new_d[2], 0.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k) atten[k] = m.alb[k] * ndd;
  } else if (is_met) {
#pragma unroll
    for (int k = 0; k < 3; ++k) { new_d[k] = md[k]; atten[k] = m.spec[k]; }
  } else if (is_die) {
    const float ior1 = outside ? 1.0f : m.refidx;
    const float ior2 = outside ? m.refidx : 1.0f;
    const float eta = ior1 / ior2;
    const float vdn = v[0] * Nn[0] + v[1] * Nn[1] + v[2] * Nn[2];
    const float vtx = Nn[0] * vdn - v[0], vty = Nn[1] * vdn - v[1],
                vtz = Nn[2] * vdn - v[2];
    const float sin_i = sqrtf(fmaxf(vtx * vtx + vty * vty + vtz * vtz, 0.0f));
    const float sin_t = eta * sin_i;
    const float cos_t = sqrtf(fmaxf(1.0f - sin_t * sin_t, 0.0f));
    const float cos_sel = ior1 > ior2 ? cos_t : vdn;
    const float q = (ior1 - ior2) / (ior1 + ior2);
    const float r0 = q * q;
    const float schl = r0 + (1.0f - r0) * pow5(fmaxf(1.0f - cos_sel, 0.0f));
    const float refl_prob = sin_t >= 1.0f ? 1.0f : schl;
    const bool take_refl = uch < refl_prob;
    if (take_refl) {
#pragma unroll
      for (int k = 0; k < 3; ++k) new_d[k] = md[k];
    } else {
      float ix = r.dx, iy = r.dy, iz = r.dz;
      norm3(ix, iy, iz);
      const float ndi = Nn[0] * ix + Nn[1] * iy + Nn[2] * iz;
      const float kref = 1.0f - eta * eta * (1.0f - ndi * ndi);
      const bool kok = kref >= 0.0f;
      const float rt = eta * ndi + sqrtf(fmaxf(kref, 0.0f));
      new_d[0] = (kok ? eta * ix - rt * Nn[0] : 0.0f) + sb[0] * m.rough;
      new_d[1] = (kok ? eta * iy - rt * Nn[1] : 0.0f) + sb[1] * m.rough;
      new_d[2] = (kok ? eta * iz - rt * Nn[2] : 0.0f) + sb[2] * m.rough;
      norm3(new_d[0], new_d[1], new_d[2]);
      refract_dir = true;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      atten[k] = (take_refl || outside) ? 1.0f
                                        : expf(-m.refract[k] * t_hit);
  } else {
    // PLASTIC
    float lx = r.ox - p[0], ly = r.oy - p[1], lz = r.oz - p[2];
    norm3(lx, ly, lz);
    float hx = v[0] + lx, hy = v[1] + ly, hz = v[2] + lz;
    norm3(hx, hy, hz);
    const float cos_p = v[0] * hx + v[1] * hy + v[2] * hz;
    float f_vec[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) f_vec[k] = fresnel1(cos_p, m.spec[k]);
    const float prob = (f_vec[0] + f_vec[1] + f_vec[2]) / 3.0f;
    if (uch < prob) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        new_d[k] = md[k];
        atten[k] = ok_met ? m.spec[k] / fmaxf(prob, 1e-8f) : 1.0f;
      }
    } else {
      new_d[0] = Nn[0] + sb[0]; new_d[1] = Nn[1] + sb[1];
      new_d[2] = Nn[2] + sb[2];
      norm3(new_d[0], new_d[1], new_d[2]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        atten[k] = (1.0f - f_vec[k]) * m.alb[k] / kPi /
                   fmaxf(1.0f - prob, 1e-8f);
    }
  }

  if (!writer) return;
  bool alive2 = ok;
  if (!ok) {
    // no-scatter absorbed: col += thr * emissive (P3D_RT.glsl:641-645)
#pragma unroll
    for (int k = 0; k < 3; ++k) col[k] = col[k] + thr[k] * m.emis[k];
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) thr[k] = thr[k] * atten[k];
    if (rr) {  // Russian roulette (P3D_RT.glsl:651-656)
      const float pmax = fmaxf(thr[0], fmaxf(thr[1], thr[2]));
      if (uni.rr() > pmax) {
        alive2 = false;
      } else {
        const float boost = 1.0f / fmaxf(pmax, 1e-12f);
#pragma unroll
        for (int k = 0; k < 3; ++k) thr[k] = thr[k] * boost;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    st[7 + k] = col[k];
    st[10 + k] = thr[k];
  }
  if (alive2) {
    const float off = refract_dir ? -kEps : kEps;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      st[k] = p[k] + Nn[k] * off;
      st[3 + k] = new_d[k];
    }
  }
  st[13] = alive2 ? 1.0f : 0.0f;
}

// Two blocks an SM: ptxas then has up to 128 registers a thread and
// spills nothing (with no floor it may hold a kernel to 80 and spill in
// the folds, as K3 measured).  One bounce of every lane of a (20, R) state
// in global memory.
__global__ void __launch_bounds__(kBounceThreads, 2) pt_bounce_kernel(
    const float* __restrict__ table, const float* __restrict__ mrow, int T,
    int S, int M, const float* __restrict__ plights, int n_pl,
    const float* __restrict__ qlights, int n_ql, float* __restrict__ state,
    const float* __restrict__ uni, int n, int rr, int grad_sky) {
  __shared__ int s_lane[kBounceThreads];
  __shared__ float s_time[kBounceThreads];
  __shared__ int s_warp[kBounceThreads / 32];
  const size_t N = n;
  const int i = blockIdx.x * kBounceThreads + threadIdx.x;
  bool live = false;
  float time = 0.0f;
  if (i < n) {  // one coalesced pass over every lane's time and flag
    time = state[6 * N + i];
    state[6 * N + i] = 0.0f;  // scattered rays carry time 0 (common.glsl:43-46)
    live = state[13 * N + i] > 0.0f;  // a dead lane's state passes through
  }
  const int n_live = drt::compact_lanes<kBounceThreads>(live, i, time,
                                                        s_lane, s_time,
                                                        s_warp);
  if (n_live == 0) return;
  const drt::Group grp = drt::make_group(n_live, kBounceThreads);
  if (!grp.active) return;  // whole groups: no vote or shuffle misses them
  const int i_lane = s_lane[grp.slot];
  bounce_lane(table, mrow, T, S, M, plights, n_pl, qlights, n_ql, grp,
              StateRows{state + i_lane, N}, s_time[grp.slot],
              StreamUniforms{uni + i_lane, N}, rr, grad_sky);
}

// The looped K6: every bounce of a block's paths in one launch.  The block
// keeps its kBounceThreads lanes' state rows in shared memory from the
// camera rays to the last bounce; before each bounce it compacts its live
// lanes again and picks its group size, as a launch a bounce does, and it
// leaves the loop when none is left.  Every thread reaches each bounce's
// barriers: a lane's early return ends its bounce, not its loop.  Writes
// col (R,3) and, for cubemap skies, the latched (throughput, direction)
// rows mw and md (R,3); with `live_count` (B,) given, thread 0 adds its
// block's live lanes at each bounce's start.
__global__ void __launch_bounds__(kBounceThreads, 2) pt_bounce_kernel_loop(
    const float* __restrict__ table, const float* __restrict__ mrow, int T,
    int S, int M, const float* __restrict__ plights, int n_pl,
    const float* __restrict__ qlights, int n_ql, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ time_in, int n,
    int n_bounces, const BounceUniforms uni, int rr, int grad_sky,
    float* __restrict__ col, float* __restrict__ mw, float* __restrict__ md,
    int* __restrict__ live_count) {
  __shared__ float s_st[kStateRows * kBounceThreads];
  __shared__ int s_lane[kBounceThreads];
  __shared__ float s_time[kBounceThreads];
  __shared__ int s_warp[kBounceThreads / 32];
  const int base = blockIdx.x * kBounceThreads;
  const int i = base + threadIdx.x;
  const bool in = i < n;
  const StateRows mine{s_st + threadIdx.x, kBounceThreads};
  // bounce_state's rows: the camera ray, colour 0, throughput 1, alive, no
  // latched miss; lanes past n are dead
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mine[k] = in ? o[3 * i + k] : 0.0f;
    mine[3 + k] = in ? d[3 * i + k] : 0.0f;
    mine[7 + k] = 0.0f;
    mine[10 + k] = 1.0f;
    mine[14 + k] = 0.0f;
    mine[17 + k] = 0.0f;
  }
  mine[6] = in ? time_in[i] : 0.0f;
  mine[13] = in ? 1.0f : 0.0f;
  for (int b = 0; b < n_bounces; ++b) {
    const float time = mine[6];
    mine[6] = 0.0f;  // scattered rays carry time 0 (common.glsl:43-46)
    const int n_live = drt::compact_lanes<kBounceThreads>(
        mine[13] > 0.0f, threadIdx.x, time, s_lane, s_time, s_warp);
    if (live_count != nullptr && threadIdx.x == 0 && n_live > 0)
      atomicAdd(live_count + b, n_live);
    if (n_live == 0) break;  // the block's count: every thread leaves
    const drt::Group grp = drt::make_group(n_live, kBounceThreads);
    if (grp.active) {  // whole groups: no vote or shuffle misses them
      const int lane = s_lane[grp.slot];
      bounce_lane(table, mrow, T, S, M, plights, n_pl, qlights, n_ql, grp,
                  StateRows{s_st + lane, kBounceThreads}, s_time[grp.slot],
                  StackedUniforms{uni, b, base + lane}, rr, grad_sky);
    }
    __syncthreads();  // the bounce's writes before the next compaction
  }
  if (!in) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    col[3 * i + k] = mine[7 + k];
    if (!grad_sky) {
      mw[3 * i + k] = mine[14 + k];
      md[3 * i + k] = mine[17 + k];
    }
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int drt_pt_closest(const void* table, const void* mats, int T,
                              int S, int M, const void* o, const void* d,
                              const void* time, int n, void* hit, void* t,
                              void* pos, void* normal, void* mat,
                              void* stream) {
  if (n > 0) {
    pt_closest_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(mats), T,
        S, M, static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(time), n,
        static_cast<unsigned char*>(hit), static_cast<float*>(t),
        static_cast<float*>(pos), static_cast<float*>(normal),
        static_cast<int*>(mat));
  }
  return static_cast<int>(cudaGetLastError());
}

// tmax: (R,) f32, or null for tmax_all on every lane.
extern "C" int drt_pt_any_hit(const void* table, int T, int S, int M,
                              const void* o, const void* d, const void* time,
                              const void* tmax, float tmax_all, int n,
                              void* occ, void* stream) {
  if (n > 0) {
    pt_any_hit_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), T, S, M,
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(time), static_cast<const float*>(tmax),
        tmax_all, n, static_cast<unsigned char*>(occ));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int drt_pt_bounce(const void* table, const void* mrow, int T,
                             int S, int M, const void* plights, int n_pl,
                             const void* qlights, int n_ql, void* state,
                             const void* uni, int n, int rr, int grad_sky,
                             void* stream) {
  if (n > 0) {
    pt_bounce_kernel<<<(n + kBounceThreads - 1) / kBounceThreads,
                       kBounceThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(mrow), T,
        S, M, static_cast<const float*>(plights), n_pl,
        static_cast<const float*>(qlights), n_ql, static_cast<float*>(state),
        static_cast<const float*>(uni), n, rr, grad_sky);
  }
  return static_cast<int>(cudaGetLastError());
}

// uni: the device pointers of BounceUniforms' five tensors (uq, uch, u3a,
// u3b, urr); strides: their bounce strides, then their lane strides, in
// elements; both arrays on the host.  mw, md: null for the gradient sky;
// live: (n_bounces,) i32 to add each bounce's live lanes to, or null.
extern "C" int drt_pt_trace(const void* table, const void* mrow, int T,
                            int S, int M, const void* plights, int n_pl,
                            const void* qlights, int n_ql, const void* o,
                            const void* d, const void* time, int n,
                            int n_bounces, const void* const* uni,
                            const long long* strides, int rr, int grad_sky,
                            void* col, void* mw, void* md, void* live,
                            void* stream) {
  if (n > 0) {
    BounceUniforms u;
    for (int x = 0; x < 5; ++x) {
      u.p[x] = static_cast<const float*>(uni[x]);
      u.sb[x] = strides[x];
      u.sr[x] = strides[5 + x];
    }
    pt_bounce_kernel_loop<<<(n + kBounceThreads - 1) / kBounceThreads,
                            kBounceThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const float*>(mrow), T,
        S, M, static_cast<const float*>(plights), n_pl,
        static_cast<const float*>(qlights), n_ql,
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(time), n, n_bounces, u, rr, grad_sky,
        static_cast<float*>(col), static_cast<float*>(mw),
        static_cast<float*>(md), static_cast<int*>(live));
  }
  return static_cast<int>(cudaGetLastError());
}
