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
// K1, redesigned for the H100.  What held the first version back: one
// thread a lane ran a serial chain of ~100 tests, each behind a type load
// and a four-way branch; 65,536 lanes in 256-thread blocks filled a
// quarter of the card's warp slots, so nothing hid that chain's latency;
// a warp ran the whole fold as soon as one of its lanes was valid (the
// deep levels of the staged ray tree hold 4-23% valid lanes); and the
// wrapper stacked nine (R,) columns into an (8, R) copy before every
// launch and returned a strided view of the normal.  The design:
//   - it reads the callers' tensors in place: o and d as (R,3), time as
//     (R,), valid as (R,) bytes or null (every lane), and writes
//     HitResult's fields itself: hit (R,) bytes, t (R,), a contiguous
//     normal (R,3), obj (R,) and mat (R,) i32;
//   - a block of kClosestThreads threads covers kClosestThreads / G0
//     lanes, G0 chosen from the launch's object and lane counts
//     (closest_lanes): each lane's fold is split over at least G0 threads
//     even when every lane is valid, so that a table of 1,005 objects
//     fills the card, and a launch of more lanes than the card holds
//     (the staged tree's deep levels, mostly invalid) takes more blocks.
//     The block writes its invalid lanes' misses in one pass and
//     compacts its valid lanes (lanes.cuh), and make_group splits each
//     over G >= G0 threads, so a sparse block splits further;
//   - it tests in K2's type runs (ops/cuda_intersect.py::type_runs):
//     spheres as 16-byte [c, r] rows, then triangles, planes and boxes,
//     kUnroll rows of a run side by side with no type branch
//     (primitives.cuh::closest_group, shared with K3's split folds).  The
//     runs reorder the objects, so a tie in t goes to the lower original
//     object id, which is the serial fold's first-wins winner; motion
//     blur moves a sphere's centre by (0,1,0) * the lane's time;
//   - the winner's normal is computed once, after the fold, from its
//     insertion-order row (prim_normal), and a missed sphere's IEEE root
//     is skipped (prim_t_n).
// Every group of a block runs the same rounds, so the warp stays in step
// with no vote.  The tests stay uncontracted, in the plain version's
// order.  Invalid lanes report a miss.  PERF.md records what each point
// bought.
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
//   runs f32: n_sph rows of 4 [c, r], then n_tri, n_pln, n_box rows of
//      12 (packed_objects' rows), 16-byte aligned; ids (O,) i32 in run
//      order; o, d (R,3) f32; valid (R,) u8 or null;
//   K1 table (O,12) f32, types (O,) i32, mats (O,) i32 in insertion order
//      (the winner's normal and material); time (R,) f32; out hit (R,)
//      u8, t (R,) f32, normal (R,3) f32, obj (R,) i32, mat (R,) i32;
//   K2 dist (R,) f32; excl (R,) i32 or null; out occ (R,) u8.
// Each launch function returns cudaGetLastError().

#include "primitives.cuh"

namespace {

// K1: threads a block; a block covers kClosestThreads / G0 lanes
constexpr int kClosestThreads = 128;
// K2: threads, and lanes, a block (128 beat 256 by 5% on the staged
// frame's launches; with 256, ptxas held K2 to 64 registers and spilled)
constexpr int kAnyThreads = 128;

// K1's type runs (K2's tables): spheres, then triangles, planes and boxes.
struct Runs {
  const float* rows;
  const int* ids;
  int n_sph, n_tri, n_pln, n_box;

  __device__ __forceinline__ drt::TypedRows<drt::kSphere> sph() const {
    return {rows, ids, n_sph};
  }
  __device__ __forceinline__ drt::TypedRows<drt::kTriangle> tri() const {
    return {rows + 4 * (size_t)n_sph, ids + n_sph, n_tri};
  }
  __device__ __forceinline__ drt::TypedRows<drt::kPlane> pln() const {
    return {tri().rows + (size_t)drt::kRowWidth * n_tri, ids + n_sph + n_tri,
            n_pln};
  }
  __device__ __forceinline__ drt::TypedRows<drt::kBox> box() const {
    return {pln().rows + (size_t)drt::kRowWidth * n_pln,
            ids + n_sph + n_tri + n_pln, n_box};
  }
};

// One block: `lanes` lanes (kClosestThreads / G0), their valid lanes
// compacted, each one's fold split over the group make_group gives it.
__global__ void __launch_bounds__(kClosestThreads) closest_hit_kernel(
    Runs runs, const float* __restrict__ table, const int* __restrict__ types,
    const int* __restrict__ mats, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ time,
    const unsigned char* __restrict__ valid, int n, int lanes,
    int motion_blur, unsigned char* __restrict__ hit, float* __restrict__ t,
    float* __restrict__ nrm, int* __restrict__ obj, int* __restrict__ mat) {
  __shared__ int s_lane[kClosestThreads];
  __shared__ int s_warp[kClosestThreads / 32];
  const int i = blockIdx.x * lanes + threadIdx.x;
  bool live = false;
  if (threadIdx.x < lanes && i < n) {
    live = valid == nullptr || valid[i] != 0;
    if (!live) {  // a miss, in one pass over the invalid lanes
      hit[i] = 0;
      t[i] = drt::kFltMax;
      nrm[3 * i] = nrm[3 * i + 1] = nrm[3 * i + 2] = 0.0f;
      obj[i] = -1;
      mat[i] = 0;
    }
  }
  const int n_live = drt::compact_lanes<kClosestThreads>(live, i, 0.0f,
                                                         s_lane, nullptr,
                                                         s_warp);
  if (n_live == 0) return;
  const drt::Group grp = drt::make_group(n_live, kClosestThreads);
  if (!grp.active) return;  // whole groups: no shuffle misses them
  const int lane = s_lane[grp.slot];
  const drt::Ray r{o[3 * lane], o[3 * lane + 1], o[3 * lane + 2],
                   d[3 * lane], d[3 * lane + 1], d[3 * lane + 2]};
  const float tm = time[lane];
  const bool mb = motion_blur != 0;
  float bt;
  const int gid = drt::closest_group(grp, r, tm, mb, &bt, runs.sph(),
                                     runs.tri(), runs.pln(), runs.box());
  if (grp.sub != 0) return;
  float n3[3] = {0.0f, 0.0f, 0.0f};
  if (gid >= 0)
    drt::prim_normal(__ldg(types + gid), r,
                     table + (size_t)gid * drt::kRowWidth, bt, tm, mb, n3);
  hit[lane] = gid >= 0 ? 1 : 0;
  t[lane] = bt;
  nrm[3 * lane] = n3[0];
  nrm[3 * lane + 1] = n3[1];
  nrm[3 * lane + 2] = n3[2];
  obj[lane] = gid;
  mat[lane] = gid >= 0 ? __ldg(mats + gid) : 0;
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

// K1's lanes a block: kClosestThreads / G0, G0 a power of two (at most
// drt::kMaxGroup): the largest that leaves each thread of a lane's group
// at least kClosestTests of the n_obj tests, doubled when the launch has
// more lanes than the card holds threads of closest_hit_kernel at once
// (lanes.cuh's persistent_grid).  Such launches are the staged tree's deep
// levels, most of whose lanes are invalid: halving a block's lanes
// doubles the blocks, and make_group gives each valid lane twice the
// threads.  PERF.md has the measurements that chose it.
constexpr int kClosestTests = 128;
int closest_lanes(int n, int n_obj) {
  static int blocks[drt::kMaxDevices] = {};
  const int res =
      drt::persistent_grid<kClosestThreads>(closest_hit_kernel, blocks) *
      kClosestThreads;
  int g = 1;
  while (g < drt::kMaxGroup && n_obj >= 2 * g * kClosestTests) g *= 2;
  if (n > res && g < drt::kMaxGroup) g *= 2;
  return kClosestThreads / g;
}

}  // namespace

extern "C" int drt_closest_hit(const void* runs, const void* ids, int n_sph,
                               int n_tri, int n_pln, int n_box,
                               const void* table, const void* types,
                               const void* mats, const void* o, const void* d,
                               const void* time, const void* valid, int n,
                               int motion_blur, void* hit, void* t,
                               void* normal, void* obj, void* mat,
                               void* stream) {
  if (n > 0) {
    const int lanes = closest_lanes(n, n_sph + n_tri + n_pln + n_box);
    closest_hit_kernel<<<(n + lanes - 1) / lanes, kClosestThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        Runs{static_cast<const float*>(runs), static_cast<const int*>(ids),
             n_sph, n_tri, n_pln, n_box},
        static_cast<const float*>(table), static_cast<const int*>(types),
        static_cast<const int*>(mats), static_cast<const float*>(o),
        static_cast<const float*>(d), static_cast<const float*>(time),
        static_cast<const unsigned char*>(valid), n, lanes, motion_blur,
        static_cast<unsigned char*>(hit), static_cast<float*>(t),
        static_cast<float*>(normal), static_cast<int*>(obj),
        static_cast<int*>(mat));
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
