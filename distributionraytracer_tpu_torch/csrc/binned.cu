// K9 binned primary closest hit: each 128-ray chain streams its candidate
// object groups front to back and stops early.
//
// Replaces distributionraytracer_tpu/accel/pallas_binned.py::binned_closest
// (_make_binned_closest_kernel).  A host-side conservative screen binning
// (accel/cuda_binned.py::build_primary_bins) gives chain c the object groups
// cand[chain_start[c]:chain_start[c+1]], sorted by cand_dist, a lower bound
// of any member's hit t from the eye (primary directions are unit, so t is
// a distance).  Per lane the result is the strict-< closest hit over the
// chain's candidates in list order, the first winning a tie; the list is a
// superset of every object a primary ray of the chain can hit.
// Bound: the object tests of the groups each chain streams before it stops
// (FP32 ALU); candidate lists and group records are read once per chain.
// Design: one 128-thread block per chain (lane = thread).  Before each
// candidate group a block vote (__syncthreads_and) stops the chain once
// every live lane's best t is below that group's cand_dist: no later group
// can then win.  The block stages the group's 8 slot records (8 x 16 f32)
// in shared memory; each thread tests them in slot order.  Dead lanes
// (valid == 0, or past the end of the batch) vote to stop and test nothing.
// The JAX kernel's slab/blk_owner/blk_dist/tile_start streaming layout is a
// DMA artifact this design does not need.
// Layouts (all contiguous):
//   objs (G*8,16) f32 slot records of the grouped tables (type -1: inert);
//   chain_start (C+1,) i32, cand (P,) i32 group ids, cand_dist (P,) f32;
//   rays (8,R) f32 rows ox oy oz dx dy dz time valid, R <= C*128;
//   out_f (4,R) f32 rows t nx ny nz, out_i (R,) i32 object id.

#include "primitives.cuh"

namespace {

constexpr int kChain = 128;  // rays per chain = threads per block
constexpr int kGroup = 8;    // object slots per group
constexpr int kSlotWidth = 16;

__global__ void binned_closest_kernel(const float* __restrict__ objs,
                                      const int* __restrict__ chain_start,
                                      const int* __restrict__ cand,
                                      const float* __restrict__ cand_dist,
                                      const float* __restrict__ rays, int n,
                                      int motion_blur,
                                      float* __restrict__ out_f,
                                      int* __restrict__ out_i) {
  __shared__ float group[kGroup * kSlotWidth];
  const int c = blockIdx.x;
  const int i = c * kChain + threadIdx.x;
  const size_t N = n;
  drt::Ray r{};
  float time = 0.0f;
  bool valid = false;
  if (i < n) {
    r = drt::Ray{rays[i], rays[N + i], rays[2 * N + i], rays[3 * N + i],
                 rays[4 * N + i], rays[5 * N + i]};
    time = rays[6 * N + i];
    valid = rays[7 * N + i] != 0.0f;
  }
  float bt = drt::kFltMax, nrm[3] = {0.0f, 0.0f, 0.0f};
  int gid = -1;
  const int s = chain_start[c], e = chain_start[c + 1];
  for (int k = s; k < e; ++k) {
    // front-to-back stop: every live lane already beats this group
    if (__syncthreads_and(!valid || bt < __ldg(cand_dist + k))) break;
    const float* src = objs + (size_t)__ldg(cand + k) * kGroup * kSlotWidth;
    group[threadIdx.x] = __ldg(src + threadIdx.x);  // 128 floats, one each
    __syncthreads();
    if (valid) {
#pragma unroll 1
      for (int j = 0; j < kGroup; ++j) {
        const float* row = group + j * kSlotWidth;
        const int typ = __float_as_int(row[12]);
        if (typ < 0) continue;  // inert padding slot
        const float t = drt::prim_t<false>(typ, r, row, time,
                                           motion_blur != 0);
        if (t < bt) {
          bt = t;
          gid = __float_as_int(row[13]);
          drt::prim_normal<false>(typ, r, row, t, time, motion_blur != 0,
                                  nrm);
        }
      }
    }
  }
  if (i < n) {
    out_f[i] = bt;
    out_f[N + i] = nrm[0];
    out_f[2 * N + i] = nrm[1];
    out_f[3 * N + i] = nrm[2];
    out_i[i] = gid;
  }
}

}  // namespace

extern "C" int drt_binned_closest(const void* objs, const void* chain_start,
                                  int n_chains, const void* cand,
                                  const void* cand_dist, const void* rays,
                                  int n, int motion_blur, void* out_f,
                                  void* out_i, void* stream) {
  if (n > 0 && n_chains > 0) {
    binned_closest_kernel<<<n_chains, kChain, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(objs),
        static_cast<const int*>(chain_start), static_cast<const int*>(cand),
        static_cast<const float*>(cand_dist),
        static_cast<const float*>(rays), n, motion_blur,
        static_cast<float*>(out_f), static_cast<int*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}
