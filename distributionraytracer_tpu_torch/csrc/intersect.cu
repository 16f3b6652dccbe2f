// K1 closest hit and K2 any hit, brute force over the scene's objects.
//
// Replaces distributionraytracer_tpu/ops/pallas_intersect.py:
//   K1 closest_hit_pallas (_closest_kernel over _fold_objects),
//   K2 any_hit_pallas (_anyhit_kernel).
// Bound: FP32 instruction throughput.  Each ray lane tests objects (rays
// x objects primitive tests, uncontracted: each mul/add its own
// instruction); memory traffic is one read of the ray streams and one
// write of the result, the table reads are warp-uniform broadcasts that
// stay in L1.
//
// K1: one thread per ray lane, objects walked in insertion order so the
// strict-< first-wins tie order of the reference is kept; the per-object
// type branch is uniform across the warp.  Lanes with valid == 0 skip the
// fold and write a miss.
//
// K2, redesigned for the H100.  What held the first version back: one
// thread a lane ran a serial chain of 102 tests, each behind a type load,
// a four-way branch and a data-dependent exit, so nothing overlapped one
// test with the next; a warp ran the whole fold as soon as one of its 32
// lanes was valid (the deep levels of the Whitted tree hold 4-23% valid
// lanes); and the wrapper stacked nine (R,) columns into an (8, R) copy
// before every launch.  The design:
//   - it reads the callers' tensors in place: o and d as (R,3), dist as
//     (R,), excl as (R,) i32 or null (no exclusion), valid as (R,) bytes or
//     null (every lane);
//   - it tests in type runs (ops/cuda_intersect.py::type_runs): spheres as
//     16-byte rows, then triangles, planes and boxes in 12-float rows, each
//     row read with 16-byte loads, with each row's original object id for
//     the excluded-id compare.  An any-hit is an OR of per-object
//     predicates, so the order of the tests does not change the result;
//   - a block of kAnyThreads lanes writes its invalid lanes' zeros in one
//     coalesced pass and compacts its valid lanes (lanes.cuh); a block
//     whose valid lanes fill it (G = 1) gives each lane one thread, one
//     with fewer splits each lane's fold over G = 2..32 threads;
//   - either way a thread tests kUnroll objects of a run side by side
//     (primitives.cuh::round_occludes, shared with K3's split shadow
//     folds), and the warp's groups run the rounds together, one ballot a
//     round giving each group its vote; a group that has found its
//     occluder sits the rest out, and the warp leaves a run when all have
//     (any_warp).  A vote by group mask, as K3's any_group, let the
//     groups of a warp run apart and cost more than the first version;
//   - a missed sphere's IEEE root is skipped (primitives.cuh::prim_t_n).
// Shadow rays carry time 0: with motion blur a sphere's centre moves by
// (0,1,0) * 0, which leaves every test's value unchanged, so K2 takes no
// motion blur flag.  Every skip is exact: the occlusion equals the plain
// version's on every lane.  PERF.md records what each point bought.
//
// Layouts (all contiguous):
//   table (O,12) f32, types (O,) i32, mats (O,) i32;
//   K1 rays (8,R) f32 rows ox oy oz dx dy dz time valid;
//      out_f (4,R) f32 rows t nx ny nz; out_i (2,R) i32 rows obj mat;
//   K2 runs f32: n_sph rows of 4 [c, r], then n_tri, n_pln, n_box rows of
//      12 (packed_objects' rows), 16-byte aligned; ids (O,) i32 in run
//      order; o, d (R,3) f32; dist (R,) f32; excl (R,) i32 or null;
//      valid (R,) u8 or null; out occ (R,) u8.
// Each launch function returns cudaGetLastError().

#include "primitives.cuh"

namespace {

constexpr int kThreads = 256;                   // K1: threads a block
// K2: threads, and lanes, a block (128 beat 256 by 5% on the staged
// frame's launches; with 256, ptxas held K2 to 64 registers and spilled)
constexpr int kAnyThreads = 128;

__global__ void closest_hit_kernel(const float* __restrict__ table,
                                   const int* __restrict__ types,
                                   const int* __restrict__ mats, int n_obj,
                                   const float* __restrict__ rays, int n,
                                   int motion_blur, float* __restrict__ out_f,
                                   int* __restrict__ out_i) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = drt::kFltMax;
  float nrm[3] = {0.0f, 0.0f, 0.0f};
  int gid = -1;
  if (rays[7 * (size_t)n + i] != 0.0f) {
    drt::Ray r{rays[i], rays[(size_t)n + i], rays[2 * (size_t)n + i],
               rays[3 * (size_t)n + i], rays[4 * (size_t)n + i],
               rays[5 * (size_t)n + i]};
    gid = drt::closest_fold(table, types, n_obj, r, rays[6 * (size_t)n + i],
                            motion_blur != 0, &t, nrm);
  }
  out_f[i] = t;
  out_f[(size_t)n + i] = nrm[0];
  out_f[2 * (size_t)n + i] = nrm[1];
  out_f[3 * (size_t)n + i] = nrm[2];
  out_i[i] = gid;
  out_i[(size_t)n + i] = gid >= 0 ? __ldg(mats + gid) : 0;
}

// One block of kAnyThreads lanes: their valid lanes compacted, each run's
// fold split over the group that make_group gives every valid lane.
__global__ void __launch_bounds__(kAnyThreads) any_hit_kernel(
    const float* __restrict__ runs, const int* __restrict__ ids, int n_sph,
    int n_tri, int n_pln, int n_box, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ dist,
    const int* __restrict__ excl, const unsigned char* __restrict__ valid,
    int n, int mode, unsigned char* __restrict__ occ) {
  __shared__ int s_lane[kAnyThreads];
  __shared__ int s_warp[kAnyThreads / 32];
  const int i = blockIdx.x * kAnyThreads + threadIdx.x;
  bool live = false;
  if (i < n) {
    live = valid == nullptr || valid[i] != 0;
    if (!live) occ[i] = 0;  // one coalesced pass over the invalid lanes
  }
  const int n_live = drt::compact_lanes<kAnyThreads>(live, i, 0.0f, s_lane,
                                                     nullptr, s_warp);
  if (n_live == 0) return;
  const drt::Group grp = drt::make_group(n_live, kAnyThreads);
  // the warp's working threads, balloted while the warp is whole
  const unsigned warp = __ballot_sync(0xffffffffu, grp.active);
  if (!grp.active) return;  // whole groups: no vote misses them
  const int lane = s_lane[grp.slot];
  const drt::Ray r{o[3 * lane], o[3 * lane + 1], o[3 * lane + 2],
                   d[3 * lane], d[3 * lane + 1], d[3 * lane + 2]};
  const float dl = dist[lane];
  const int ex = excl != nullptr ? excl[lane] : -1;
  // the runs, spheres first; a run's rounds end when every group of the
  // warp has found its occluder
  const float* tri = runs + 4 * (size_t)n_sph;
  const float* pln = tri + (size_t)drt::kRowWidth * n_tri;
  const float* box = pln + (size_t)drt::kRowWidth * n_pln;
  const int* tid = ids + n_sph;
  bool hit = drt::any_warp(drt::TypedRows<drt::kSphere>{runs, ids, n_sph},
                           grp, warp, r, dl, ex, mode, false, false);
  hit = drt::any_warp(drt::TypedRows<drt::kTriangle>{tri, tid, n_tri}, grp,
                      warp, r, dl, ex, mode, false, hit);
  hit = drt::any_warp(drt::TypedRows<drt::kPlane>{pln, tid + n_tri, n_pln},
                      grp, warp, r, dl, ex, mode, false, hit);
  hit = drt::any_warp(drt::TypedRows<drt::kBox>{box, tid + n_tri + n_pln,
                                                n_box},
                      grp, warp, r, dl, ex, mode, false, hit);
  if (grp.sub == 0) occ[lane] = hit ? 1 : 0;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int drt_closest_hit(const void* table, const void* types,
                               const void* mats, int n_obj, const void* rays,
                               int n, int motion_blur, void* out_f,
                               void* out_i, void* stream) {
  if (n > 0) {
    closest_hit_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(types),
        static_cast<const int*>(mats), n_obj, static_cast<const float*>(rays),
        n, motion_blur, static_cast<float*>(out_f), static_cast<int*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int drt_any_hit(const void* runs, const void* ids, int n_sph,
                           int n_tri, int n_pln, int n_box, const void* o,
                           const void* d, const void* dist, const void* excl,
                           const void* valid, int n, int mode, void* occ,
                           void* stream) {
  if (n > 0) {
    any_hit_kernel<<<(n + kAnyThreads - 1) / kAnyThreads, kAnyThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(runs), static_cast<const int*>(ids), n_sph,
        n_tri, n_pln, n_box, static_cast<const float*>(o),
        static_cast<const float*>(d), static_cast<const float*>(dist),
        static_cast<const int*>(excl),
        static_cast<const unsigned char*>(valid), n, mode,
        static_cast<unsigned char*>(occ));
  }
  return static_cast<int>(cudaGetLastError());
}
