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
// Once a lane's best t is below a group's cand_dist, no group from there on
// can beat it, so a lane may stop testing there and the result does not
// change: where the stream stops decides which tests run, never the hit.
// Bound: the object tests of the groups streamed before the stops (FP32
// ALU); the rays, candidate lists and group records read once.
// What held the first version back: one 128-thread block a chain, with two
// block barriers a candidate group (a stop vote, and the group's records
// staged in shared memory), its slots tested one after another; the
// launch was one wave of 2,048 blocks, so it lasted as long as its longest
// chain, and a chain's vote waited for its slowest warp.  The design, in
// three launches with no host synchronisation:
//   1. closest_scan (one block): each chain's list is split into segments
//      of kSegGroups groups; item_start is the exclusive scan of each
//      chain's segments past its first, and the unit counter is zeroed;
//   2. closest_items: a persistent grid of warps takes units from an
//      atomic counter: first (chain, quarter) for every chain's first
//      segment, then (tail segment, quarter), a quarter being 32 of the
//      chain's 128 lanes.  A warp streams its segment's groups in order,
//      each group's 8 slot records (512 bytes) staged in the warp's own
//      shared memory while the next group's load is in flight, 8 slots
//      tested kU side by side; it leaves when every live lane's best
//      (its own, or the best another unit has published for it) is below
//      the next group's cand_dist (__all_sync: no block barrier).  A lane
//      publishes each improvement with a 64-bit atomicMin of (t bits << 32
//      | position * 8 + slot): t >= 0, so its bits order as integers, and
//      the least key is the least t, of equal t the first in list order,
//      which is the serial fold's winner whichever unit finds it and in
//      whatever order the units run;
//   3. closest_finish: each lane decodes its key and computes the winner's
//      normal once.
// o, d, time and valid are read in place; the keys (memset to all ones, a
// miss), item_start and the counter are the wrapper's scratch.
//
// K10 replaces pallas_binned.py::binned_shadow (_make_binned_shadow_kernel).
// accel/cuda_binned.py::build_light_bins tiles each point light's view of
// the scene box K x K (frames row l: light xyz, tile axes u v, axis w, the
// tangent half-extents sx sy) and lists in tile (l, ty, tx) the object
// groups whose boxes it covers, ascending in their least distance from the
// light.  Chain c (lanes 128c..128c+127) takes the light of its first
// lane.  Each lane maps its origin to its tile; the chain's live lanes give
// the tile rectangle tx0..tx1 x ty0..ty1 and the distance cut maxd = max
// |o - L| + 1e-3.  The chain tests every entry of the rectangle's tiles up
// to each tile's first one past maxd (an occluder between an origin and
// the light is nearer the light than the origin).  A lane is occluded when
// a slot hits it at time 0 with t <= dist + EPSILON (BVH scenes) or t <
// dist (grid scenes).  Occlusion is an OR over the tested set, and the
// tile arithmetic is uncontracted in the plain version's order
// (binned_shadow_plain), so K10 equals it on every lane.
// Bound: the object tests of the entries each chain streams, up to each
// lane's first occluder (FP32 ALU), and the tile arithmetic of every lane.
// What held the first version back: one 128-thread block a chain streamed
// the chain's entries with two block barriers each, and the chains are
// skewed (on the box-ground frame's primary shadows a median of 6 entries,
// a maximum of 15,051), so the launch took as long as its longest chain
// while the card idled.  The design spreads each chain's stream over the
// card in three launches:
//   1. shadow_chains: a block a chain computes its light, rectangle and
//      maxd, zeroes its lanes' output, and lists its stream: the rows of
//      its rectangle, each row's tiles one contiguous span of the bin
//      entries (x fastest), as a prefix over the rows (`rows`), and the
//      number of work items, ceil(positions / E), E = kItemEntries;
//   2. shadow_scan: one block scans the items into item_start;
//   3. shadow_items: a persistent grid of warps takes (item, quarter)
//      units from an atomic counter.  A unit is 32 of the chain's lanes
//      and at most E consecutive positions of its stream; the warp reads
//      32 positions' distances and groups at once, keeps those within
//      maxd (in a tile that is a prefix, as gdist ascends: the cut), and
//      tests each kept entry's 8 slots on its lanes, kU side by side.  A
//      group's slot records (512 bytes) are staged in the warp's own
//      shared memory, one 16-byte load a lane, the next kept entry's
//      loaded while the warp tests the current one: a warp's entries are
//      a chain of dependent tests, and a version that read each slot's
//      record from the cache as it tested it waited on those reads at
//      every slot.  No block barrier: the warp votes
//      (__all_sync) to leave once its lanes are dead or occluded.  A lane
//      writes only a 1, when it is occluded, so units of one chain OR
//      their results in any order; a unit also skips lanes that another
//      unit has occluded.
// o, d, dist and valid are read in place; no host synchronisation.
// Layouts (all contiguous):
//   objs (G*8,16) f32 slot records of the grouped tables (type -1: inert);
//   chain_start (C+1,) i32, cand (P,) i32 group ids, cand_dist (P,) f32;
//   K9: o, d (R,3) f32, time (R,) f32, valid (R,) u8 or null (every
//   lane), R <= C*128; out t (R,) f32, normal (R,3) f32, obj (R,) i32;
//   scratch keys (R,) u64, item_start (C+1,) i32, counter (1,) i32;
//   K10: tile_start (L*K*K+1,) i32, frames (L,16) f32, group (Q,) i32
//   group ids, gdist (Q,) f32; o, d (R,3) f32, dist (R,) f32, valid (R,)
//   u8 or null (every lane), light_id (R,) i32, occ (R,) u8; scratch
//   chains (C,8) i32 [light tx0 tx1 ty0 ty1 maxd-bits positions items],
//   rows (C,K+1) i32, item_start (C+1,) i32, counter (1,) i32.

#include "primitives.cuh"

namespace {

constexpr int kChain = 128;  // rays per chain = threads per block
constexpr int kGroup = 8;    // object slots per group
constexpr int kSlotWidth = 16;

// ---------------------------------------------------------------- K10
constexpr int kWarps = kChain / 32;
constexpr int kChainInts = 8;    // a chain's record (see Layouts)
constexpr int kScanThreads = 1024;
constexpr int kUnits = kWarps;   // warp units an item: 32 lanes each
// E: stream positions (bin entries) a work item at most, chosen by
// measurement (PERF.md; accel/cuda_binned.py::ITEM_ENTRIES mirrors it)
constexpr int kItemEntries = 128;
constexpr int kGroupVecs = kGroup * kSlotWidth / 4;  // float4s a group: 32
constexpr unsigned kFull = 0xffffffffu;

struct Rect {
  int tx0, tx1, ty0, ty1;
  float od2;
};

// The block's tile rectangle over its live lanes (K, -1 where none) and
// their largest squared light distance (0 where none).
__device__ __forceinline__ Rect block_rect(Rect r) {
  __shared__ Rect part[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    r.tx0 = min(r.tx0, __shfl_xor_sync(kFull, r.tx0, off));
    r.tx1 = max(r.tx1, __shfl_xor_sync(kFull, r.tx1, off));
    r.ty0 = min(r.ty0, __shfl_xor_sync(kFull, r.ty0, off));
    r.ty1 = max(r.ty1, __shfl_xor_sync(kFull, r.ty1, off));
    r.od2 = fmaxf(r.od2, __shfl_xor_sync(kFull, r.od2, off));
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

// Exclusive prefix of v over a block of kThreads threads; *total gets the
// block's sum.  Ends with a barrier, so it may be called again at once.
template <int kThreads>
__device__ __forceinline__ int block_excl_scan(int v, int* total) {
  __shared__ int part[kThreads / 32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) part[w] = x;
  __syncthreads();
  int before = 0, sum = 0;
  for (int k = 0; k < kThreads / 32; ++k) {
    before += k < w ? part[k] : 0;
    sum += part[k];
  }
  __syncthreads();
  *total = sum;
  return before + x - v;
}

// The origin's tile along one frustum axis: clip((s / half) * 0.5 + 0.5,
// 0, 1) * K, truncated, clamped to K - 1.
__device__ __forceinline__ int frustum_tile(float s, float half, int K) {
  float x = __fadd_rn(__fmul_rn(__fdiv_rn(s, half), 0.5f), 0.5f);
  x = __fmul_rn(fminf(fmaxf(x, 0.0f), 1.0f), static_cast<float>(K));
  return min(max(static_cast<int>(x), 0), K - 1);
}

// Pass 1: chain c's light, rectangle, cut and stream.  Its stream is the
// rows ty0..ty1 of its light's tiles, each row the bin entries of tiles
// tx0..tx1 (one contiguous span); rows[c * (K + 1) + r] is the number of
// positions before row r, and rows[.. + nrow] the chain's positions.
__global__ void __launch_bounds__(kChain) shadow_chains_kernel(
    const int* __restrict__ tile_start, const float* __restrict__ frames,
    int K, const int* __restrict__ light_id, const float* __restrict__ o,
    const unsigned char* __restrict__ valid, int n,
    int* __restrict__ chains, int* __restrict__ rows,
    unsigned char* __restrict__ occ) {
  const int c = blockIdx.x;
  const int i = c * kChain + threadIdx.x;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  bool live = false;
  if (i < n) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    live = valid == nullptr || valid[i] != 0;
    occ[i] = 0;
  }
  const int li = __ldg(light_id + c * kChain);  // the chain's first lane
  const float* F = frames + li * 16;
  const float vx = __fsub_rn(ox, __ldg(F));
  const float vy = __fsub_rn(oy, __ldg(F + 1));
  const float vz = __fsub_rn(oz, __ldg(F + 2));
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
  const Rect box = block_rect(live ? Rect{tx, tx, ty, ty, od2}
                                   : Rect{K, -1, K, -1, 0.0f});
  const float maxd = __fadd_rn(__fsqrt_rn(fmaxf(box.od2, 0.0f)), 1e-3f);
  // box.ty1 < 0: no live lane, an empty stream (and tx1 + 1 is no tile)
  const int nrow = box.ty1 >= 0 ? box.ty1 - box.ty0 + 1 : 0;
  const int* ts = tile_start + (size_t)li * K * K;
  int* rp = rows + (size_t)c * (K + 1);
  int base = 0;
  for (int r0 = 0; r0 < nrow; r0 += kChain) {
    const int r = r0 + threadIdx.x;
    int len = 0;
    if (r < nrow) {
      const int* row = ts + (box.ty0 + r) * K;
      len = __ldg(row + box.tx1 + 1) - __ldg(row + box.tx0);
    }
    int sum;
    const int before = block_excl_scan<kChain>(len, &sum);
    if (r < nrow) rp[r] = base + before;
    base += sum;
  }
  if (threadIdx.x == 0) {
    rp[nrow] = base;
    int* ch = chains + (size_t)c * kChainInts;
    ch[0] = li;
    ch[1] = box.tx0;
    ch[2] = box.tx1;
    ch[3] = box.ty0;
    ch[4] = box.ty1;
    ch[5] = __float_as_int(maxd);
    ch[6] = base;
    ch[7] = (base + kItemEntries - 1) / kItemEntries;
  }
}

// Pass 2: item_start = the exclusive scan of the chains' items (and the
// total at C); the unit counter starts at 0.
__global__ void __launch_bounds__(kScanThreads) shadow_scan_kernel(
    const int* __restrict__ chains, int C, int* __restrict__ item_start,
    int* __restrict__ counter) {
  const int per = (C + kScanThreads - 1) / kScanThreads;
  const int a = min((int)threadIdx.x * per, C), b = min(a + per, C);
  int s = 0;
  for (int c = a; c < b; ++c) s += chains[(size_t)c * kChainInts + 7];
  int total;
  int at = block_excl_scan<kScanThreads>(s, &total);
  for (int c = a; c < b; ++c) {
    item_start[c] = at;
    at += chains[(size_t)c * kChainInts + 7];
  }
  if (threadIdx.x == 0) {
    item_start[C] = total;
    *counter = 0;
  }
}

// The last index in [lo, hi] whose a[] <= key, a ascending and a[lo] <=
// key: a 32-way search, each step one load a lane and a ballot.
__device__ __forceinline__ int warp_search(const int* a, int lo, int hi,
                                           int key) {
  const int lane = threadIdx.x & 31;
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step;
    const unsigned m = __ballot_sync(kFull, p <= hi && a[p] <= key);
    const int k = __popc(m);  // a ascends: the lanes below k hold
    hi = min(hi, lo + (k + 1) * step - 1);
    lo += k * step;
  }
  return lo;
}

__device__ __forceinline__ bool occludes(float t, float sd, bool grid_mode) {
  return grid_mode ? t < sd : t <= __fadd_rn(sd, drt::kEpsilon);
}

// Whether a slot of a staged group occludes the shadow ray (time 0): the
// 8 slot records, in shared memory, kU side by side (their arithmetic
// interleaves), to the round of the first that does.  Inert slots (type
// -1) take the round's real type and their results are dropped.
__device__ __forceinline__ bool group_occludes(const float* stage,
                                               const drt::Ray& r, float sd,
                                               bool grid_mode) {
#pragma unroll 1
  for (int s = 0; s < kGroup; s += drt::kUnroll) {
    int typ[drt::kUnroll], eff[drt::kUnroll];
    const float* row[drt::kUnroll];
    int real = -1;
#pragma unroll
    for (int u = 0; u < drt::kUnroll; ++u) {
      row[u] = stage + (s + u) * kSlotWidth;
      typ[u] = __float_as_int(row[u][12]);
      real = max(real, typ[u]);
    }
    if (real < 0) continue;  // four inert padding slots
#pragma unroll
    for (int u = 0; u < drt::kUnroll; ++u) eff[u] = typ[u] < 0 ? real : typ[u];
    float t[drt::kUnroll];
    drt::prim_t_n<false, drt::kUnroll>(eff, row, r, 0.0f, false, t);
    bool h = false;
#pragma unroll
    for (int u = 0; u < drt::kUnroll; ++u)
      h = h || (typ[u] >= 0 && occludes(t[u], sd, grid_mode));
    if (h) return true;
  }
  return false;
}

// Pass 3: a persistent grid of warps.  A unit is (item, quarter): the
// quarter's 32 lanes of the item's chain against positions [k E, (k + 1)
// E) of the chain's stream, k the item's index in its chain.
__global__ void __launch_bounds__(kChain) shadow_items_kernel(
    const float* __restrict__ objs, const int* __restrict__ tile_start,
    int K, const int* __restrict__ group, const float* __restrict__ gdist,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ dist, const unsigned char* __restrict__ valid,
    int n, int C, int grid_mode, const int* __restrict__ chains,
    const int* __restrict__ rows, const int* __restrict__ item_start,
    int* __restrict__ counter, unsigned char* occ) {
  __shared__ float4 stage[kWarps][2 * kGroupVecs];  // two groups a warp
  const float4* objs4 = reinterpret_cast<const float4*>(objs);
  const int lane = threadIdx.x & 31;
  const int units = item_start[C] * kUnits;
  for (;;) {
    int u = 0;
    if (lane == 0) u = atomicAdd(counter, 1);
    u = __shfl_sync(kFull, u, 0);
    if (u >= units) return;
    const int item = u / kUnits;
    const int c = warp_search(item_start, 0, C - 1, item);
    const int i = c * kChain + (u % kUnits) * 32 + lane;
    drt::Ray r{};
    float sd = 0.0f;
    bool done = true;  // dead, past the batch, or occluded
    if (i < n) {
      done = (valid != nullptr && valid[i] == 0) || __ldcg(occ + i) != 0;
      r = drt::Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2],
                   d[3 * i], d[3 * i + 1], d[3 * i + 2]};
      sd = dist[i];
    }
    if (__all_sync(kFull, done)) continue;
    const int* ch = chains + (size_t)c * kChainInts;
    const int tx0 = ch[1], tx1 = ch[2], ty0 = ch[3];
    const float maxd = __int_as_float(ch[5]);
    const int* ts = tile_start + (size_t)ch[0] * K * K;
    const int* rp = rows + (size_t)c * (K + 1);
    int pos = (item - item_start[c]) * kItemEntries;
    const int end = min(pos + kItemEntries, ch[6]);
    int ro = warp_search(rp, 0, ch[4] - ty0, pos);  // the row holding pos
    int q = ts[(ty0 + ro) * K + tx0] + pos - rp[ro];
    int qe = ts[(ty0 + ro) * K + tx1 + 1];
    while (pos < end) {
      if (q >= qe) {  // the next row (one with no entries takes no step)
        ++ro;
        q = ts[(ty0 + ro) * K + tx0];
        qe = ts[(ty0 + ro) * K + tx1 + 1];
        continue;
      }
      const int take = min(32, min(end - pos, qe - q));
      float gd = 0.0f;
      int gg = 0;
      if (lane < take) {
        gd = __ldg(gdist + q + lane);
        gg = __ldg(group + q + lane);
      }
      // a tile's entries past maxd are the end of its list: the cut
      unsigned keep = __ballot_sync(kFull, lane < take && gd <= maxd);
      if (keep) {
        // a group's 8 slot records are 32 float4s: a lane reads one, the
        // next kept entry's while the warp tests the staged one
        int j = __ffs(keep) - 1;
        keep &= keep - 1;
        float4* buf = stage[threadIdx.x >> 5];
        int cur = 0;
        buf[lane] = __ldg(objs4 + (size_t)__shfl_sync(kFull, gg, j) *
                                      kGroupVecs + lane);
        __syncwarp();
        for (;;) {
          const bool more = keep != 0;
          float4 next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (more) {
            j = __ffs(keep) - 1;
            keep &= keep - 1;
            next = __ldg(objs4 + (size_t)__shfl_sync(kFull, gg, j) *
                                     kGroupVecs + lane);
          }
          if (!done &&
              group_occludes(reinterpret_cast<const float*>(buf + cur),
                             r, sd, grid_mode != 0)) {
            done = true;
            occ[i] = 1;
          }
          // every lane is past its reads of the other stage: refill it
          if (__all_sync(kFull, done) || !more) break;
          cur ^= kGroupVecs;
          buf[cur + lane] = next;
          __syncwarp();
        }
      }
      if (!done && __ldcg(occ + i) != 0) done = true;  // another unit's
      if (__all_sync(kFull, done)) break;
      pos += take;
      q += take;
    }
  }
}

// ---------------------------------------------------------------- K9
// Candidate groups a segment at most, chosen by measurement (PERF.md;
// accel/cuda_binned.py::SEGMENT_GROUPS mirrors it)
constexpr int kSegGroups = 32;

// Pass 1: item_start = the exclusive scan of each chain's segments past
// its first (ceil(groups / kSegGroups) - 1, and 0 for an empty list), the
// total at C; the unit counter starts at 0.
__global__ void __launch_bounds__(kScanThreads) closest_scan_kernel(
    const int* __restrict__ chain_start, int C, int* __restrict__ item_start,
    int* __restrict__ counter) {
  const int per = (C + kScanThreads - 1) / kScanThreads;
  const int a = min((int)threadIdx.x * per, C), b = min(a + per, C);
  auto tail = [&](int c) {
    const int len = chain_start[c + 1] - chain_start[c];
    return len > kSegGroups ? (len - 1) / kSegGroups : 0;
  };
  int s = 0;
  for (int c = a; c < b; ++c) s += tail(c);
  int total;
  int at = block_excl_scan<kScanThreads>(s, &total);
  for (int c = a; c < b; ++c) {
    item_start[c] = at;
    at += tail(c);
  }
  if (threadIdx.x == 0) {
    item_start[C] = total;
    *counter = 0;
  }
}

// A lane's best as the 64-bit key that orders it: t's bits over the code
// position * 8 + slot (t >= 0, so its bits order as integers).
__device__ __forceinline__ unsigned long long hit_key(float t, unsigned code) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) | code;
}

// Folds a staged group's 8 slot records (shared memory) into the lane's
// best (bt, code): kU slots side by side (their arithmetic interleaves),
// strict < in slot order.  Inert slots (type -1) take the round's real
// type and their results are dropped.  Returns whether the best improved.
__device__ __forceinline__ bool group_closest(const float* stage,
                                              const drt::Ray& r, float time,
                                              bool mb, unsigned code0,
                                              float& bt, unsigned& code) {
  bool better = false;
#pragma unroll 1
  for (int s = 0; s < kGroup; s += drt::kUnroll) {
    int typ[drt::kUnroll], eff[drt::kUnroll];
    const float* row[drt::kUnroll];
    int real = -1;
#pragma unroll
    for (int u = 0; u < drt::kUnroll; ++u) {
      row[u] = stage + (s + u) * kSlotWidth;
      typ[u] = __float_as_int(row[u][12]);
      real = max(real, typ[u]);
    }
    if (real < 0) continue;  // four inert padding slots
#pragma unroll
    for (int u = 0; u < drt::kUnroll; ++u) eff[u] = typ[u] < 0 ? real : typ[u];
    float t[drt::kUnroll];
    drt::prim_t_n<false, drt::kUnroll>(eff, row, r, time, mb, t);
#pragma unroll
    for (int u = 0; u < drt::kUnroll; ++u) {
      if (typ[u] >= 0 && t[u] < bt) {
        bt = t[u];
        code = code0 + s + u;
        better = true;
      }
    }
  }
  return better;
}

// Pass 2: a persistent grid of warps.  Units [0, C * kUnits) are (chain,
// quarter) on the chain's first segment; unit C * kUnits + k * kUnits + q
// is quarter q on tail item k: segment 1 + k - item_start[c] of the chain
// c that holds item k.  A quarter is 32 of the chain's lanes.
__global__ void __launch_bounds__(kChain) closest_items_kernel(
    const float* __restrict__ objs, const int* __restrict__ chain_start,
    const int* __restrict__ cand, const float* __restrict__ cand_dist,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ time, const unsigned char* __restrict__ valid,
    int n, int C, int motion_blur, const int* __restrict__ item_start,
    int* __restrict__ counter, unsigned long long* keys) {
  __shared__ float4 stage[kWarps][kGroupVecs];  // a group a warp
  const float4* objs4 = reinterpret_cast<const float4*>(objs);
  // the high words of the keys: the t a lane's best has so far
  const unsigned* key_t = reinterpret_cast<const unsigned*>(keys) + 1;
  float4* buf = stage[threadIdx.x >> 5];
  const float* fbuf = reinterpret_cast<const float*>(buf);
  const int lane = threadIdx.x & 31;
  const bool mb = motion_blur != 0;
  const int head = C * kUnits;
  const int units = head + item_start[C] * kUnits;
  for (;;) {
    int u = 0;
    if (lane == 0) u = atomicAdd(counter, 1);
    u = __shfl_sync(kFull, u, 0);
    if (u >= units) return;
    int c = u / kUnits, seg = 0;
    if (u >= head) {
      const int item = (u - head) / kUnits;
      c = warp_search(item_start, 0, C - 1, item);
      seg = 1 + item - item_start[c];
    }
    const int i = c * kChain + (u % kUnits) * 32 + lane;
    bool live = false;
    drt::Ray r{};
    float tm = 0.0f;
    // the best another unit has published (a NaN before any: no best)
    float known = drt::kFltMax;
    if (i < n && (valid == nullptr || valid[i] != 0)) {
      live = true;
      r = drt::Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2],
                   d[3 * i], d[3 * i + 1], d[3 * i + 2]};
      tm = time[i];
      known = __uint_as_float(__ldcg(key_t + 2 * (size_t)i));
    }
    if (!__any_sync(kFull, live)) continue;
    const int first = __ldg(chain_start + c) + seg * kSegGroups;
    const int end = min(first + kSegGroups, __ldg(chain_start + c + 1));
    float bt = drt::kFltMax;
    unsigned code = 0;
    bool stop = false;
    for (int base = first; base < end && !stop; base += 32) {
      const int take = min(32, end - base);
      float cd = 0.0f;
      int grp = 0;
      if (lane < take) {
        cd = __ldg(cand_dist + base + lane);
        grp = __ldg(cand + base + lane);
      }
      // group j's 8 slot records are 32 float4s: a lane loads one, the
      // next group's while the warp tests this one
      float4 next = __ldg(objs4 + (size_t)__shfl_sync(kFull, grp, 0) *
                                      kGroupVecs + lane);
      for (int j = 0; j < take; ++j) {
        // front-to-back stop: every live lane's best beats this group
        const float dj = __shfl_sync(kFull, cd, j);
        if (__all_sync(kFull, !live || fminf(bt, known) < dj)) {
          stop = true;
          break;
        }
        buf[lane] = next;
        __syncwarp();
        const int gn = __shfl_sync(kFull, grp, min(j + 1, take - 1));
        if (j + 1 < take)
          next = __ldg(objs4 + (size_t)gn * kGroupVecs + lane);
        if (live) {
          const float kn = __uint_as_float(__ldcg(key_t + 2 * (size_t)i));
          if (group_closest(fbuf, r, tm, mb, (unsigned)(base + j) * kGroup,
                            bt, code))
            atomicMin(keys + i, hit_key(bt, code));
          known = kn;
        }
        __syncwarp();  // every lane is past its reads: the stage is free
      }
    }
  }
}

// Pass 3: each lane's winner from its key (all ones: no hit), its normal
// computed once.
__global__ void closest_finish_kernel(
    const float* __restrict__ objs, const int* __restrict__ cand,
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ time, int n, int motion_blur,
    const unsigned long long* __restrict__ keys, float* __restrict__ t,
    float* __restrict__ nrm, int* __restrict__ obj) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  float bt = drt::kFltMax, n3[3] = {0.0f, 0.0f, 0.0f};
  int gid = -1;
  if (key != ~0ull) {
    const unsigned code = static_cast<unsigned>(key);
    const float* slot =
        objs + ((size_t)__ldg(cand + (code / kGroup)) * kGroup +
                code % kGroup) * kSlotWidth;
    bt = __uint_as_float(static_cast<unsigned>(key >> 32));
    gid = __float_as_int(__ldg(slot + 13));
    const drt::Ray r{o[3 * i], o[3 * i + 1], o[3 * i + 2],
                     d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    drt::prim_normal(__float_as_int(__ldg(slot + 12)), r, slot, bt, time[i],
                     motion_blur != 0, n3);
  }
  t[i] = bt;
  nrm[3 * i] = n3[0];
  nrm[3 * i + 1] = n3[1];
  nrm[3 * i + 2] = n3[2];
  obj[i] = gid;
}

// Persistent blocks of the kChain-thread kernels: as many as fit on the
// current card at once.
int items_grid() {
  static int blocks[drt::kMaxDevices] = {};
  return drt::persistent_grid<kChain>(shadow_items_kernel, blocks);
}

int closest_grid() {
  static int blocks[drt::kMaxDevices] = {};
  return drt::persistent_grid<kChain>(closest_items_kernel, blocks);
}

}  // namespace

// valid: (R,) u8, or null for every lane live.  A memset of the keys and
// three launches (scan, items, finish); the scratch is the caller's.
extern "C" int drt_binned_closest(const void* objs, const void* chain_start,
                                  int n_chains, const void* cand,
                                  const void* cand_dist, const void* o,
                                  const void* d, const void* time,
                                  const void* valid, int n, int motion_blur,
                                  void* keys, void* item_start, void* counter,
                                  void* t, void* normal, void* obj,
                                  void* stream) {
  if (n > 0 && n_chains > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* k = static_cast<unsigned long long*>(keys);
    const auto* cs = static_cast<const int*>(chain_start);
    const auto* fo = static_cast<const float*>(o);
    const auto* fd = static_cast<const float*>(d);
    const auto* ft = static_cast<const float*>(time);
    cudaMemsetAsync(k, 0xff, sizeof(unsigned long long) * (size_t)n, st);
    closest_scan_kernel<<<1, kScanThreads, 0, st>>>(
        cs, n_chains, static_cast<int*>(item_start),
        static_cast<int*>(counter));
    closest_items_kernel<<<closest_grid(), kChain, 0, st>>>(
        static_cast<const float*>(objs), cs, static_cast<const int*>(cand),
        static_cast<const float*>(cand_dist), fo, fd, ft,
        static_cast<const unsigned char*>(valid), n, n_chains, motion_blur,
        static_cast<const int*>(item_start), static_cast<int*>(counter), k);
    closest_finish_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(objs), static_cast<const int*>(cand), fo,
        fd, ft, n, motion_blur, k, static_cast<float*>(t),
        static_cast<float*>(normal), static_cast<int*>(obj));
  }
  return static_cast<int>(cudaGetLastError());
}

// valid: (R,) u8, or null for every lane live.  Three launches (chains,
// scan, items); the scratch is the caller's.
extern "C" int drt_binned_shadow(const void* objs, const void* tile_start,
                                 const void* frames, int K, const void* group,
                                 const void* gdist, const void* light_id,
                                 const void* o, const void* d,
                                 const void* dist, const void* valid, int n,
                                 int grid_mode, void* chains,
                                 void* rows, void* item_start, void* counter,
                                 void* occ, void* stream) {
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int C = (n + kChain - 1) / kChain;
    const auto* vl = static_cast<const unsigned char*>(valid);
    shadow_chains_kernel<<<C, kChain, 0, st>>>(
        static_cast<const int*>(tile_start),
        static_cast<const float*>(frames), K,
        static_cast<const int*>(light_id), static_cast<const float*>(o), vl,
        n, static_cast<int*>(chains), static_cast<int*>(rows),
        static_cast<unsigned char*>(occ));
    shadow_scan_kernel<<<1, kScanThreads, 0, st>>>(
        static_cast<const int*>(chains), C, static_cast<int*>(item_start),
        static_cast<int*>(counter));
    shadow_items_kernel<<<items_grid(), kChain, 0, st>>>(
        static_cast<const float*>(objs), static_cast<const int*>(tile_start),
        K, static_cast<const int*>(group), static_cast<const float*>(gdist),
        static_cast<const float*>(o), static_cast<const float*>(d),
        static_cast<const float*>(dist), vl, n, C, grid_mode,
        static_cast<const int*>(chains), static_cast<const int*>(rows),
        static_cast<const int*>(item_start), static_cast<int*>(counter),
        static_cast<unsigned char*>(occ));
  }
  return static_cast<int>(cudaGetLastError());
}
