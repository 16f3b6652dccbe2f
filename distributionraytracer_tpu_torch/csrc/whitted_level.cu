// K3: one whole Whitted ray-tree level in one pass.
//
// Replaces distributionraytracer_tpu/ops/pallas_whitted.py::fused_level
// (_level_kernel), both modes.  Per ray lane:
//   closest hit over the packed table (strict-< first wins), then the
//   winner's 13 material fields from the (O,13) per-object rows;
//   per light: Blinn-Phong (light colour ignored, main.cpp:446-449) and a
//   shadow fold with the accel-NONE rules (distance 1.0 in 'reference'
//   shadow mode, t > 1e-4, self-exclusion; main.cpp:399-440);
//   with spawn: refraction and reflection children (Schlick cos selection,
//   Beer, TIR => F = 1, reflection gate; main.cpp:456-518).
// Grid mode (gbox != nullptr, the uniform grid's observable semantics,
// pallas_whitted.py:83-121, 179-196): the Init_Traverse slab over the grid
// box gives (ok, t1); a closest hit counts iff ok && t < t1 (walking out of
// the grid drops the record; the winner's material and normal are kept as
// the fold found them); the occluder compare is a strict t < dist with no
// self-exclusion, and a shadow ray whose slab init fails is shadowed.
// Bound on this card: the latency of each lane's folds, a dependent chain
// of ~100 uncontracted tests x (1 + lights) with IEEE sqrt and divisions
// in it, with too few warps to hide it; rays x objects x (1 + lights)
// tests per level at the FP32 peak take a fraction of the time.  Memory
// traffic is 11 input and 4 or 29 output f32 streams per lane; on the
// tree loop's route, 10 output streams and each child's 11 input streams
// of the next level (a dead lane writes 10 and its children's valid rows).  What held
// the first version (one thread per lane, 128 a block) back, and what
// this design does about it (lanes.cuh):
//   - divergence on invalid lanes: level L holds tile x 2^L lanes, of which
//     4-23% are valid past level 0, and a warp with one valid lane paid
//     that lane's whole fold.  A block of kThreads lanes compacts its
//     valid lanes; invalid lanes write their zero rows in one coalesced
//     pass first, and warps with no valid lane leave;
//   - a block whose valid lanes fill its threads (G = 1) runs the serial
//     folds (primitives.cuh); a block with fewer splits each valid lane's
//     folds over a group of G = 2..32 threads, each testing every G-th
//     object, drt::kUnroll at a time written so that their arithmetic
//     interleaves; the closest hit is a shuffle reduction (least t, then
//     least index: the serial fold's winner; primitives.cuh::
//     closest_group, which K1 shares), the shadow folds vote after each
//     round and stop at the first occluder's round (primitives.cuh::
//     any_group, which K2 shares);
//   - the IEEE root of every missed sphere: sphere_t returns on a negative
//     (or NaN) discriminant before its sqrt and divisions;
//   - the winner's normal (a sqrt and three divisions) is computed once,
//     after the fold.
// Each of these is exact: the results equal the first version's.
// PERF.md records what each point bought on the card.
//
// Layouts (all contiguous):
//   table (O,12) f32, types (O,) i32, mrow (O,13) f32
//     [cd3, cs3, kd, ks, kr, shine, T, ior, pad];
//   lights (L,9) f32 [pos3, e1_3, e2_3], light_quad (L,) i32;
//   gbox (6,) f32 [grid bbox_min, bbox_max], or null (accel NONE);
//   rays (11,R) f32 rows ox oy oz dx dy dz time ior lsx lsy valid;
//   out (4,R) or (29,R) f32, in the order of fused_level's outputs;
//   with next (spawn only): out (10,R) f32 [direct3, hit, refr weight3,
//   refl weight3], what the bottom-up combine reads, and next the next
//   level's (11, b*R) rays.  R = n_nodes * tile lanes run node-major
//   (lane j * tile + r is node j of primary ray r), and child k of that
//   lane lands at lane (j * b + k) * tile + r of next, b the number of
//   child kinds spawned (refr_k, refl_k: a kind's k, or -1 if pruned).
//   A dead child (of an invalid lane) gets only its valid row: the next
//   level reads a lane's other rows only where its valid row is nonzero.

#include "lanes.cuh"
#include "primitives.cuh"

namespace {

constexpr int kThreads = drt::kLaneBlock;  // threads, and lanes, a block
constexpr int kMatWidth = 13;
constexpr float kOffset = 1e-4f;  // secondary/shadow ray offset (main.cpp:378)

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-24f));
  x *= inv; y *= inv; z *= inv;
}

// The lane of next that child k of lane i takes (see Layouts above).
__device__ __forceinline__ size_t child_lane(int i, int k, int tile, int b) {
  const int j = i / tile;
  return ((size_t)j * b + k) * tile + (i - j * tile);
}

// One child's 11 input rows of the next level (children carry time 0).
__device__ __forceinline__ void write_child(float* c, size_t NN, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float ior,
                                            float lsx, float lsy, bool valid) {
  c[0] = ox; c[NN] = oy; c[2 * NN] = oz;
  c[3 * NN] = dx; c[4 * NN] = dy; c[5 * NN] = dz;
  c[6 * NN] = 0.0f;
  c[7 * NN] = ior;
  c[8 * NN] = lsx; c[9 * NN] = lsy;
  c[10 * NN] = valid ? 1.0f : 0.0f;
}

// Init_Traverse's slab (grid.cpp:104-171, accel/grid.py::
// _init_traverse_batched): whether the ray meets the grid box, and its exit.
__device__ __forceinline__ bool grid_slab(const float* gbox,
                                          const drt::Ray& r, float* t1) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float d[3] = {r.dx, r.dy, r.dz};
  float t0 = 0.0f, te = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = 1.0f / d[k];
    const float lo = __ldg(gbox + k), hi = __ldg(gbox + 3 + k);
    const float tn = a >= 0.0f ? (lo - o[k]) * a : (hi - o[k]) * a;
    const float tf = a >= 0.0f ? (hi - o[k]) * a : (lo - o[k]) * a;
    t0 = k == 0 ? tn : drt::max_nan(t0, tn);
    te = k == 0 ? tf : drt::min_nan(te, tf);
  }
  *t1 = te;
  return !(t0 > te || te < 0.0f);
}

// Two blocks an SM: ptxas then has up to 128 registers a thread and
// spills nothing (with no floor it holds this kernel to 80 and spills in
// the folds).
__global__ void __launch_bounds__(kThreads, 2) whitted_level_kernel(
    const float* __restrict__ table, const int* __restrict__ types,
    const float* __restrict__ mrow, int n_obj,
    const float* __restrict__ lights, const int* __restrict__ light_quad,
    int n_lights, const float* __restrict__ gbox,
    const float* __restrict__ rays, int n, int motion_blur, int spawn,
    int ref_shadow, float* __restrict__ out, float* __restrict__ next,
    int tile, int refr_k, int refl_k) {
  __shared__ int s_lane[kThreads];
  __shared__ int s_warp[kThreads / 32];
  const size_t N = n;
  const int b = (refr_k >= 0) + (refl_k >= 0);
  const size_t NN = N * b;  // next's lanes
  const int n_out = !spawn ? 4 : (next != nullptr ? 10 : 29);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool valid = false;
  if (i < n) {
    valid = !(rays[10 * N + i] == 0.0f);
    if (!valid) {  // one coalesced pass of zero rows
      for (int k = 0; k < n_out; ++k) out[k * N + i] = 0.0f;
      if (next != nullptr)
        for (int k = 0; k < b; ++k)
          next[10 * NN + child_lane(i, k, tile, b)] = 0.0f;
    }
  }
  const int live = drt::compact_lanes<kThreads>(valid, i, 0.0f, s_lane,
                                                nullptr, s_warp);
  if (live == 0) return;
  const drt::Group grp = drt::make_group(live, kThreads);
  if (!grp.active) return;  // whole groups: no vote or shuffle misses them
  // A block whose valid lanes fill its threads (G = 1) runs the serial
  // folds (primitives.cuh), whose loop the compiler unrolls itself; the
  // others split theirs over their groups.
  const bool serial = grp.size == 1;
  const bool writer = grp.sub == 0;
  const bool mb = motion_blur != 0;
  const int lane = s_lane[grp.slot];
  const drt::Ray r{rays[lane], rays[N + lane], rays[2 * N + lane],
                   rays[3 * N + lane], rays[4 * N + lane],
                   rays[5 * N + lane]};
  const float time = rays[6 * N + lane];
  const float ior1 = rays[7 * N + lane];
  const float lsx = rays[8 * N + lane];
  const float lsy = rays[9 * N + lane];

  // ---- closest hit, the winner's normal and material ----
  float t_hit;
  float nrm[3] = {0.0f, 0.0f, 0.0f};
  int gid;
  if (serial) {
    gid = drt::closest_fold(table, types, n_obj, r, time, mb, &t_hit, nrm);
  } else {
    gid = drt::closest_group(grp, r, time, mb, &t_hit,
                             drt::MixedRows{table, types, n_obj});
    if (gid >= 0)
      drt::prim_normal(__ldg(types + gid), r,
                       table + (size_t)gid * drt::kRowWidth, t_hit, time, mb,
                       nrm);
  }
  bool hit = gid >= 0;
  if (gbox != nullptr) {
    float t1;
    const bool ok = grid_slab(gbox, r, &t1);
    hit = hit && ok && t_hit < t1;
  }
  float m[kMatWidth];
#pragma unroll
  for (int k = 0; k < kMatWidth; ++k)
    m[k] = gid >= 0 ? __ldg(mrow + (size_t)gid * kMatWidth + k) : 0.0f;
  const float kd = m[6], ks = m[7], kr = m[8], shine = m[9], trans = m[10],
              mat_ior = m[11];

  float nx = nrm[0], ny = nrm[1], nz = nrm[2];
  norm3(nx, ny, nz);
  const float t_safe = hit ? t_hit : 1.0f;
  const float px = r.ox + r.dx * t_safe;
  const float py = r.oy + r.dy * t_safe;
  const float pz = r.oz + r.dz * t_safe;
  // normal flip when hit from inside (main.cpp:363-364)
  const bool outside = (r.dx * nx + r.dy * ny + r.dz * nz) < 0.0f;
  const float sgn = outside ? 1.0f : -1.0f;
  const float Nx = nx * sgn, Ny = ny * sgn, Nz = nz * sgn;
  float vx = r.dx, vy = r.dy, vz = r.dz;
  norm3(vx, vy, vz);
  vx = -vx; vy = -vy; vz = -vz;

  // ---- direct lighting (main.cpp:383-451) ----
  float direct[3] = {0.0f, 0.0f, 0.0f};
  float llx = 0.0f, lly = 0.0f, llz = 0.0f;
  const int mode = gbox == nullptr ? drt::kModeNone : drt::kModeGrid;
  for (int j = 0; j < n_lights; ++j) {
    const float* L = lights + (size_t)j * 9;
    float lpx = __ldg(L + 0), lpy = __ldg(L + 1), lpz = __ldg(L + 2);
    if (__ldg(light_quad + j)) {
      lpx = lpx + __ldg(L + 3) * lsx + __ldg(L + 6) * lsy;
      lpy = lpy + __ldg(L + 4) * lsx + __ldg(L + 7) * lsy;
      lpz = lpz + __ldg(L + 5) * lsx + __ldg(L + 8) * lsy;
    }
    llx = lpx; lly = lpy; llz = lpz;
    const float ulx = lpx - px, uly = lpy - py, ulz = lpz - pz;
    const float dist_true =
        sqrtf(fmaxf(ulx * ulx + uly * uly + ulz * ulz, 1e-24f));
    const float lx = ulx / dist_true, ly = uly / dist_true,
                lz = ulz / dist_true;
    float hx = lx + vx, hy = ly + vy, hz = lz + vz;
    norm3(hx, hy, hz);
    const float ndl = fmaxf(Nx * lx + Ny * ly + Nz * lz, 0.0f);
    const float ndh = fmaxf(Nx * hx + Ny * hy + Nz * hz, 0.0f);
    const drt::Ray sray{px + Nx * kOffset, py + Ny * kOffset,
                        pz + Nz * kOffset, lx, ly, lz};
    // grid mode: a shadow ray whose slab init fails is shadowed untested
    bool want = hit;
    if (hit && gbox != nullptr) {
      float t_exit;
      want = grid_slab(gbox, sray, &t_exit);
    }
    const float sdist = ref_shadow ? 1.0f : dist_true;
    if (!want ||
        (serial ? drt::any_fold(table, types, n_obj, sray, sdist, gid, mode,
                                mb)
                : drt::any_group(drt::MixedRows{table, types, n_obj}, grp,
                                 sray, sdist, gid, mode, mb)))
      continue;
    const float spec = powf(fmaxf(ndh, 1e-12f), shine);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      direct[k] += m[k] * (kd * ndl) + m[3 + k] * (ks * spec);
  }
  if (!writer) return;

  out[lane] = direct[0];
  out[N + lane] = direct[1];
  out[2 * N + lane] = direct[2];
  out[3 * N + lane] = hit ? 1.0f : 0.0f;
  if (!spawn) return;

  // ---- children (main.cpp:456-518) ----
  const float ior2 = outside ? mat_ior : 1.0f;
  const float eta = ior1 / ior2;
  const float vdn = vx * Nx + vy * Ny + vz * Nz;
  const float vtx = Nx * vdn - vx, vty = Ny * vdn - vy, vtz = Nz * vdn - vz;
  const float sin_i = sqrtf(fmaxf(vtx * vtx + vty * vty + vtz * vtz, 0.0f));
  const float inv_si = 1.0f / fmaxf(sin_i, 1e-12f);
  const float sin_t = eta * sin_i;
  const bool no_tir = sin_t < 1.0f;
  const float cos_t = sqrtf(fmaxf(1.0f - sin_t * sin_t, 0.0f));
  const bool pos_si = sin_i > 0.0f;
  float rdx = pos_si ? vtx * inv_si * sin_t - Nx * cos_t : -Nx;
  float rdy = pos_si ? vty * inv_si * sin_t - Ny * cos_t : -Ny;
  float rdz = pos_si ? vtz * inv_si * sin_t - Nz * cos_t : -Nz;
  norm3(rdx, rdy, rdz);

  const float cos_theta = ior1 > ior2 ? cos_t : vdn;
  const float rq = (ior1 - ior2) / (ior1 + ior2);
  const float r0 = rq * rq;
  const float c1 = fmaxf(1.0f - cos_theta, 0.0f);
  const float fres = r0 + (1.0f - r0) * (c1 * c1 * c1 * c1 * c1);

  const bool do_refr = hit && trans == 1.0f && no_tir;
  const float krf =
      do_refr ? fres : ((hit && trans > 0.0f && !no_tir) ? 1.0f : kr);
  const float t_beer = (hit && !outside) ? t_hit : 0.0f;

  float flx = Nx * (2.0f * vdn) - vx;
  float fly = Ny * (2.0f * vdn) - vy;
  float flz = Nz * (2.0f * vdn) - vz;
  norm3(flx, fly, flz);
  const bool refl_gate = (flx * Nx + fly * Ny + flz * Nz) > 0.0f;
  const bool do_refl = hit && ks > 0.0f && refl_gate;

  const float ro[3] = {px - Nx * kOffset, py - Ny * kOffset,
                       pz - Nz * kOffset};
  const float fo[3] = {px + Nx * kOffset, py + Ny * kOffset,
                       pz + Nz * kOffset};
  float refr_w[3], refl_w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float beer = outside ? 1.0f : expf((1.0f - m[k]) * (-t_beer));
    refr_w[k] = do_refr ? beer * (1.0f - krf) : 0.0f;
    refl_w[k] = do_refl ? m[3 + k] * krf : 0.0f;
  }

  if (next != nullptr) {  // the combine's weights; the children into next
    float* w = out + 4 * N + lane;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w[k * N] = refr_w[k];
      w[(3 + k) * N] = refl_w[k];
    }
    if (refr_k >= 0)
      write_child(next + child_lane(lane, refr_k, tile, b), NN, ro[0], ro[1],
                  ro[2], rdx, rdy, rdz, ior2, llx, lly, do_refr);
    if (refl_k >= 0)
      write_child(next + child_lane(lane, refl_k, tile, b), NN, fo[0], fo[1],
                  fo[2], flx, fly, flz, ior1, llx, lly, do_refl);
    return;
  }

  float* o = out + 4 * N + lane;
  o[0] = do_refr ? 1.0f : 0.0f;
  o[1 * N] = ro[0];
  o[2 * N] = ro[1];
  o[3 * N] = ro[2];
  o[4 * N] = rdx;
  o[5 * N] = rdy;
  o[6 * N] = rdz;
  o[7 * N] = ior2;
#pragma unroll
  for (int k = 0; k < 3; ++k) o[(8 + k) * N] = refr_w[k];
  o[11 * N] = do_refl ? 1.0f : 0.0f;
  o[12 * N] = fo[0];
  o[13 * N] = fo[1];
  o[14 * N] = fo[2];
  o[15 * N] = flx;
  o[16 * N] = fly;
  o[17 * N] = flz;
  o[18 * N] = ior1;
#pragma unroll
  for (int k = 0; k < 3; ++k) o[(19 + k) * N] = refl_w[k];
  o[22 * N] = llx;
  o[23 * N] = lly;
  o[24 * N] = llz;
}

}  // namespace

// gbox: null for accel NONE, the grid's (6,) f32 box for grid mode;
// next: null for the 29-row output, else the next level's rays (spawn
// only; n a multiple of tile, and at least one of refr_k, refl_k >= 0).
extern "C" int drt_whitted_level(const void* table, const void* types,
                                 const void* mrow, int n_obj,
                                 const void* lights, const void* light_quad,
                                 int n_lights, const void* gbox,
                                 const void* rays, int n, int motion_blur,
                                 int spawn, int ref_shadow, void* out,
                                 void* next, int tile, int refr_k, int refl_k,
                                 void* stream) {
  if (n > 0) {
    whitted_level_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(types),
        static_cast<const float*>(mrow), n_obj,
        static_cast<const float*>(lights),
        static_cast<const int*>(light_quad), n_lights,
        static_cast<const float*>(gbox), static_cast<const float*>(rays), n,
        motion_blur, spawn, ref_shadow, static_cast<float*>(out),
        static_cast<float*>(next), tile, refr_k, refl_k);
  }
  return static_cast<int>(cudaGetLastError());
}
