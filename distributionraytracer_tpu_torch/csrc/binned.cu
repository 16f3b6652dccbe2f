// K9 binned primary closest hit: each 128-ray chain streams its candidate
// object groups front to back and stops early.  K10 binned shadow any-hit:
// each 128-lane shadow chain streams the occluder groups of the light-frustum
// tiles its origins cover.
//
// K9 replaces distributionraytracer_tpu/accel/pallas_binned.py::
// binned_closest (_make_binned_closest_kernel).  A host-side conservative
// screen binning (accel/cuda_binned.py::build_primary_bins) gives chain c the
// object groups cand[chain_start[c]:chain_start[c+1]], sorted by cand_dist, a
// lower bound of any member's hit t from the eye (primary directions are
// unit, so t is a distance).  Per lane the result is the strict-< closest hit
// over the chain's candidates in list order, the first winning a tie; the
// list is a superset of every object a primary ray of the chain can hit.
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
//
// K10 replaces pallas_binned.py::binned_shadow (_make_binned_shadow_kernel).
// accel/cuda_binned.py::build_light_bins tiles each point light's view of
// the scene box K x K (frames row l: light xyz, tile axes u v, axis w, the
// tangent half-extents sx sy) and lists in tile (l, ty, tx) the object
// groups whose boxes it covers, ascending in their least distance from the
// light.  Chain c takes the light of its first lane.  Each lane maps its
// origin to its tile; the block reduces the live lanes' tile rectangle
// tx0..tx1 x ty0..ty1 and the distance cut maxd = max |o - L| + 1e-3, then
// streams, row by row and tile by tile, each tile's groups up to the first
// one past maxd (an occluder between an origin and the light is nearer the
// light than the origin).  A lane is occluded when a slot hits it at time 0
// with t <= dist + EPSILON (BVH scenes) or t < dist (grid scenes); the chain
// stops when a block vote finds every live lane occluded.  Occlusion is an
// OR over the tested set, and the tile arithmetic is uncontracted in the
// plain version's order (binned_shadow_plain), so K10 equals it on every
// lane.  A chain without a live lane streams nothing.
// Bound: the object tests of the entries each chain streams, up to each
// lane's first occluder (FP32 ALU), and the tile arithmetic of every lane.
// The JAX kernel's dense (120, Q) entry slab is a DMA layout: here the block
// stages each entry's 8 slot records from the grouped tables, as K9 does.
// Layouts (all contiguous):
//   objs (G*8,16) f32 slot records of the grouped tables (type -1: inert);
//   chain_start (C+1,) i32, cand (P,) i32 group ids, cand_dist (P,) f32;
//   rays (8,R) f32 rows ox oy oz dx dy dz time valid, R <= C*128 (K10: row
//   6 is the shadow distance);
//   out_f (4,R) f32 rows t nx ny nz, out_i (R,) i32 object id;
//   tile_start (L*K*K+1,) i32, frames (L,16) f32, group (Q,) i32 group
//   ids, gdist (Q,) f32, light_id (R,) i32, occ (R,) u8.

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

// ---------------------------------------------------------------- K10
constexpr int kWarps = kChain / 32;

struct Rect {
  int tx0, tx1, ty0, ty1;
  float od2;
};

// The block's tile rectangle over its live lanes (K, -1 where none) and
// their largest squared light distance (0 where none).
__device__ __forceinline__ Rect block_rect(Rect r) {
  __shared__ Rect part[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    r.tx0 = min(r.tx0, __shfl_xor_sync(0xffffffffu, r.tx0, off));
    r.tx1 = max(r.tx1, __shfl_xor_sync(0xffffffffu, r.tx1, off));
    r.ty0 = min(r.ty0, __shfl_xor_sync(0xffffffffu, r.ty0, off));
    r.ty1 = max(r.ty1, __shfl_xor_sync(0xffffffffu, r.ty1, off));
    r.od2 = fmaxf(r.od2, __shfl_xor_sync(0xffffffffu, r.od2, off));
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = r;
  __syncthreads();
  r = part[0];
  for (int w = 1; w < kWarps; ++w) {
    r.tx0 = min(r.tx0, part[w].tx0);
    r.tx1 = max(r.tx1, part[w].tx1);
    r.ty0 = min(r.ty0, part[w].ty0);
    r.ty1 = max(r.ty1, part[w].ty1);
    r.od2 = fmaxf(r.od2, part[w].od2);
  }
  return r;
}

// The origin's tile along one frustum axis: clip((s / half) * 0.5 + 0.5,
// 0, 1) * K, truncated, clamped to K - 1.
__device__ __forceinline__ int frustum_tile(float s, float half, int K) {
  float x = __fadd_rn(__fmul_rn(__fdiv_rn(s, half), 0.5f), 0.5f);
  x = __fmul_rn(fminf(fmaxf(x, 0.0f), 1.0f), static_cast<float>(K));
  return min(max(static_cast<int>(x), 0), K - 1);
}

__global__ void binned_shadow_kernel(const float* __restrict__ objs,
                                     const int* __restrict__ tile_start,
                                     const float* __restrict__ frames, int K,
                                     const int* __restrict__ group,
                                     const float* __restrict__ gdist,
                                     const int* __restrict__ light_id,
                                     const float* __restrict__ rays, int n,
                                     int grid_mode,
                                     unsigned char* __restrict__ occ_out) {
  __shared__ float slots[kGroup * kSlotWidth];
  const int c = blockIdx.x;
  const int i = c * kChain + threadIdx.x;
  const size_t N = n;
  drt::Ray r{};
  float sd = 0.0f;
  bool valid = false;
  if (i < n) {
    r = drt::Ray{rays[i], rays[N + i], rays[2 * N + i], rays[3 * N + i],
                 rays[4 * N + i], rays[5 * N + i]};
    sd = rays[6 * N + i];
    valid = rays[7 * N + i] != 0.0f;
  }
  const int li = __ldg(light_id + c * kChain);  // the chain's first lane
  const float* F = frames + li * 16;
  const float vx = __fsub_rn(r.ox, __ldg(F));
  const float vy = __fsub_rn(r.oy, __ldg(F + 1));
  const float vz = __fsub_rn(r.oz, __ldg(F + 2));
  const float aw = drt::dot3_rn(vx, vy, vz, __ldg(F + 9), __ldg(F + 10),
                                __ldg(F + 11));
  const float aws = aw > 1e-9f ? aw : 1.0f;
  const float su = __fdiv_rn(
      drt::dot3_rn(vx, vy, vz, __ldg(F + 3), __ldg(F + 4), __ldg(F + 5)), aws);
  const float tv = __fdiv_rn(
      drt::dot3_rn(vx, vy, vz, __ldg(F + 6), __ldg(F + 7), __ldg(F + 8)), aws);
  const int tx = frustum_tile(su, __ldg(F + 12), K);
  const int ty = frustum_tile(tv, __ldg(F + 13), K);
  const float od2 = drt::dot3_rn(vx, vy, vz, vx, vy, vz);
  const Rect box = block_rect(valid ? Rect{tx, tx, ty, ty, od2}
                                    : Rect{K, -1, K, -1, 0.0f});
  const float maxd = __fadd_rn(__fsqrt_rn(fmaxf(box.od2, 0.0f)), 1e-3f);
  bool occ = false;
  const int* ts = tile_start + (size_t)li * K * K;
  // box.ty1 < 0: no live lane, nothing to stream (and tx1 + 1 is no tile)
  for (int ty = box.ty0; ty <= box.ty1; ++ty) {
    for (int t = ty * K + box.tx0; t <= ty * K + box.tx1; ++t) {
      const int e = __ldg(ts + t + 1);
      for (int q = __ldg(ts + t); q < e; ++q) {
        if (__ldg(gdist + q) > maxd) break;  // the tile's rest is farther
        if (__syncthreads_and(!valid || occ)) goto done;
        const float* src =
            objs + (size_t)__ldg(group + q) * kGroup * kSlotWidth;
        slots[threadIdx.x] = __ldg(src + threadIdx.x);
        __syncthreads();
        if (valid && !occ) {
#pragma unroll 1
          for (int j = 0; j < kGroup; ++j) {
            const float* row = slots + j * kSlotWidth;
            const int typ = __float_as_int(row[12]);
            if (typ < 0) continue;  // inert padding slot
            const float th = drt::prim_t<false>(typ, r, row, 0.0f, false);
            if (grid_mode ? th < sd : th <= __fadd_rn(sd, drt::kEpsilon)) {
              occ = true;
              break;
            }
          }
        }
      }
    }
  }
done:
  if (i < n) occ_out[i] = occ ? 1 : 0;
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

extern "C" int drt_binned_shadow(const void* objs, const void* tile_start,
                                 const void* frames, int K, const void* group,
                                 const void* gdist, const void* light_id,
                                 const void* rays, int n, int grid_mode,
                                 void* occ, void* stream) {
  if (n > 0) {
    binned_shadow_kernel<<<(n + kChain - 1) / kChain, kChain, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(objs), static_cast<const int*>(tile_start),
        static_cast<const float*>(frames), K, static_cast<const int*>(group),
        static_cast<const float*>(gdist), static_cast<const int*>(light_id),
        static_cast<const float*>(rays), n, grid_mode,
        static_cast<unsigned char*>(occ));
  }
  return static_cast<int>(cudaGetLastError());
}
