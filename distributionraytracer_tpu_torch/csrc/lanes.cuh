// Block-level lane work shared by K1 and K2 (intersect.cu), K3
// (whitted_level.cu) and K6 (pt.cu): compaction of a block's live lanes,
// and thread groups that split one lane's object folds; and, for K1's
// grouping and K9's and K10's persistent grids (binned.cu), the number of
// a kernel's blocks that the card holds at once.
//
// A block covers as many lanes as it has threads.  Each thread brings one
// lane's live flag; the live lanes are listed in lane order in shared
// memory (ballot and popc within a warp, a scan over the warps' counts).
// The block then picks a group size G (1, 2, 4, ... 32 threads a lane) so
// that its live lanes fill its threads: group k takes live lane k.  With
// G = 1 (at least half the block's lanes live) each thread runs its lane's
// folds (K3, K6: the serial folds; K2: its rounds); with G > 1 each thread
// of a group folds every G-th object of the table, kUnroll objects side by
// side.  The fold's results do not
// depend on the order in which lanes are taken, and the closest-hit
// reduction below reproduces the serial fold's "strict <, first wins"
// exactly, so all of this is exact.
#pragma once

#include <cuda_runtime.h>

namespace drt {

constexpr int kLaneBlock = 256;  // threads, and lanes, a block of K3 and K6
constexpr int kMaxGroup = 32;    // most threads a lane's fold is split over
constexpr int kUnroll = 4;       // objects a thread tests side by side

// One group of G threads working on one live lane.
struct Group {
  int size;       // G: threads a lane, a power of two <= 32
  int sub;        // this thread's index in its group, 0..G-1
  int slot;       // the live lane this thread works on: its compacted index
  bool active;    // false: beyond the block's live lanes (whole groups)
  unsigned mask;  // the group's lanes within the warp
};

// The smallest G such that doubling it would not fit the live lanes into
// the block's threads (at most kMaxGroup).  `live` > 0.
__device__ __forceinline__ Group make_group(int live, int threads) {
  int g = 1;
  while (g < kMaxGroup && live * g * 2 <= threads) g *= 2;
  Group grp;
  grp.size = g;
  grp.sub = threadIdx.x & (g - 1);
  grp.slot = threadIdx.x / g;
  grp.active = grp.slot < live;
  grp.mask = g == 32 ? 0xffffffffu
                     : ((1u << g) - 1u) << ((threadIdx.x & 31) & ~(g - 1));
  return grp;
}

// Lists the lanes whose `live` is true, in lane order: list[k] = lane of
// the k-th live lane, vals[k] = its `val`.  Every thread of the block must
// call it.  Returns the number of live lanes.
template <int kThreads>
__device__ __forceinline__ int compact_lanes(bool live, int lane, float val,
                                             int* list, float* vals,
                                             int* warp_count) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const unsigned b = __ballot_sync(0xffffffffu, live);
  if (l == 0) warp_count[w] = __popc(b);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    const int c = warp_count[k];
    base += k < w ? c : 0;
    total += c;
  }
  if (live) {
    const int slot = base + __popc(b & ((1u << l) - 1u));
    list[slot] = lane;
    if (vals != nullptr) vals[slot] = val;
  }
  __syncthreads();
  return total;
}

// The closest-hit reduction over a group: least t, and among equal t the
// least object index (-1, no hit, only ever pairs with the miss t).  The
// serial fold keeps the first of equal t, which is the least index, and t
// is never NaN on a hit, so this is the serial fold's winner.  `extra`
// travels with the winner.
__device__ __forceinline__ void group_min(const Group& grp, float& t,
                                          int& obj, int& extra) {
  for (int off = grp.size >> 1; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(grp.mask, t, off, grp.size);
    const int oo = __shfl_xor_sync(grp.mask, obj, off, grp.size);
    const int oe = __shfl_xor_sync(grp.mask, extra, off, grp.size);
    if (ot < t || (ot == t && static_cast<unsigned>(oo) <
                                  static_cast<unsigned>(obj))) {
      t = ot;
      obj = oo;
      extra = oe;
    }
  }
}

// Blocks of a kThreads-thread kernel that the current card holds at once
// (at least 1), found once for each device; `blocks` is the kernel's own
// cache, zeroed.
constexpr int kMaxDevices = 64;
template <int kThreads, class Kernel>
int persistent_grid(Kernel kernel, int (&blocks)[kMaxDevices]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxDevices && blocks[dev] > 0) return blocks[dev];
  int sms = 0, per = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, 0);
  const int b = sms * per > 0 ? sms * per : 1;
  if (dev >= 0 && dev < kMaxDevices) blocks[dev] = b;
  return b;
}

}  // namespace drt
