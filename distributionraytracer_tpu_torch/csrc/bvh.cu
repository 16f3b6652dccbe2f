// K7 grouped walk and K8 threaded walk: closest and any hit over a
// threaded, leaf-collapsed BVH.
//
// Replace distributionraytracer_tpu/accel/pallas_packet.py::
// make_grouped_intersectors (K7, its _dispatch pallas_call) and
// accel/pallas_bvh.py::make_pallas_bvh_intersectors (K8).  Both compute the
// per-lane stackless walk of accel/bvh.py::threaded_walk, their plain
// version: at a node, the entry-t slab test with the inside-box t := 0 fix
// (bvh.cpp:256-257) either descends to node + 1 or jumps to the skip link;
// closest hit prunes entry_t >= best_t; a leaf tests its object slots in
// order with a strict <, so the first object wins a tie.  Shadow rays run
// at time 0, accept t <= dist + EPSILON (bvh mode, bvh.cpp:376) or t < dist
// (grid mode, grid.cpp:330-352), have no self-exclusion and stop at the
// first occluder.  The walks keep that DFS order, pruning and slot order,
// so ids and occlusion equal the plain walk's on every lane.
//
// Bound on this card: neither bytes nor FP32 work.  The tables (~9 MB for
// 100,000 triangles) sit in L2, and a lane's node slab tests and object
// tests (the plain walk counts them) take ~1% of a launch at the FP32
// peak.  A lane's walk is a chain of dependent node loads and tests whose
// length is heavy-tailed, and a warp takes as long as its longest lane.
// What the first version (a thread a lane, the leaf loop inside the node
// loop; K8 a warp's union walk) lost, and what this design does about it
// (PERF.md gives what each point bought):
//   - lanes of a warp split between node steps and leaf tests, so a warp
//     paid its longest leaf loop at every step where any lane sat on a
//     leaf.  The walk is "while-while": a lane steps through inner nodes
//     and rejected boxes until it holds a leaf to test or its walk ends
//     (next_leaf); the warp's walking threads then vote (__any_sync) and
//     test their leaves together.  The vote makes the reconvergence
//     explicit: left to the compiler it came and went with the code's
//     shape;
//   - a leaf's slots are tested kU side by side (inert and past-the-end
//     slots masked), so the tests of one lane interleave;
//   - the winner's normal is computed once, after the walk;
//   - K8's union walk (32, 16 or 8 lanes sharing a cursor) lost to this
//     per-lane walk on K8's own tables by ~3x, so K8 is this walk on its
//     tables, under kernel symbols of its own.
// Measured and left out: listing a block's live lanes so that warps carry
// live lanes only (lanes.cuh::compact_lanes), with a leaf's tests split
// over G = 2..8 threads where a block is short of lanes (a tie on K7's
// launches once the vote was in); fetching both possible next node records
// before the slab test resolves (slower once the warps reconverge); a
// block pool of several chunks whose threads take a new lane when a walk
// ends (it scatters coherent shadow lanes across warps); 256-lane blocks;
// a 64-register bound (it spills).  A thread whose lane is invalid writes
// its miss row and leaves; the warp's votes name the threads that walk.
//
// Layouts (all contiguous):
//   nodes (N,8) f32 = N x {float4 [bmin xyz, link bits],
//                          float4 [bmax xyz, slot_count bits]},
//     link = the skip target of an inner node (slot_count 0), the first
//     slot of a leaf, whose skip target is node + 1 (DFS pre-order);
//   objs (S,16) f32 slot records [12 params, type bits, id bits, 0, 0]
//     (type -1: an inert slot padding K7's 8-slot groups);
//   rays (8,R) f32 rows ox oy oz dx dy dz time|dist valid;
//   closest out_f (4,R) f32 rows t nx ny nz, out_i (R,) i32 object id;
//   shadow occ (R,) u8.
// Each launch function returns cudaGetLastError().

#include "primitives.cuh"

namespace {

constexpr int kThreads = 128;  // threads, and lanes, a block (beat 256)
constexpr int kU = 4;  // slots a thread tests side by side
constexpr int kSlotWidth = 16;
constexpr unsigned kFullMask = 0xffffffffu;  // a block is whole warps

// A node record as stored: a = [bmin xyz, link], b = [bmax xyz, count].
struct Rec {
  float4 a, b;
};

__device__ __forceinline__ Rec load_rec(const float4* nodes, int i) {
  return Rec{__ldg(nodes + 2 * i), __ldg(nodes + 2 * i + 1)};
}

// The root's record (a tree of no node: a record no walk reads).
__device__ __forceinline__ Rec root_rec(const float4* nodes, int n_nodes) {
  return n_nodes > 0 ? load_rec(nodes, 0) : Rec{};
}

__device__ __forceinline__ int rec_link(const Rec& nd) {
  return __float_as_int(nd.a.w);
}

__device__ __forceinline__ int rec_count(const Rec& nd) {
  return __float_as_int(nd.b.w);
}

struct Lane {
  drt::Ray r;
  float inv[3];
  float time;  // closest: the ray's time; shadow: the occluder distance
};

__device__ __forceinline__ Lane load_lane(const float* rays, int n, int i) {
  const size_t N = n;
  Lane l;
  l.r = drt::Ray{rays[i], rays[N + i], rays[2 * N + i], rays[3 * N + i],
                 rays[4 * N + i], rays[5 * N + i]};
  l.inv[0] = 1.0f / l.r.dx;
  l.inv[1] = 1.0f / l.r.dy;
  l.inv[2] = 1.0f / l.r.dz;
  l.time = rays[6 * N + i];
  return l;
}

// Entry-t slab test (boundingBox.cpp:64-124), NaN-propagating min/max as
// the plain version's amax/amin; entry t := 0 when the origin is inside.
__device__ __forceinline__ bool slab(const Lane& l, const Rec& nd,
                                     float* tent) {
  const float o[3] = {l.r.ox, l.r.oy, l.r.oz};
  const float lo[3] = {nd.a.x, nd.a.y, nd.a.z};
  const float hi[3] = {nd.b.x, nd.b.y, nd.b.z};
  float t0 = 0.0f, t1 = 0.0f;
  bool inside = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ta = (lo[k] - o[k]) * l.inv[k];
    const float tb = (hi[k] - o[k]) * l.inv[k];
    const bool pos = l.inv[k] >= 0.0f;
    const float tn = pos ? ta : tb;
    const float tf = pos ? tb : ta;
    t0 = k == 0 ? tn : drt::max_nan(t0, tn);
    t1 = k == 0 ? tf : drt::min_nan(t1, tf);
    inside = inside && o[k] > lo[k] && o[k] < hi[k];
  }
  *tent = inside ? 0.0f : (t0 < 0.0f ? t1 : t0);
  return t0 < t1 && t1 > 0.0f;
}

// Slots s .. s + kU - 1 of a leaf ending at `end`
// against one ray: t[u], FLT_MAX for a slot past the end or an inert one.
// Past-the-end slots test the leaf's last slot again and inert slots (zero
// rows) take the round's real type, so that the kU tests are always there
// and of one type where the leaf's objects are: they interleave.
__device__ __forceinline__ void test_slots(const float* __restrict__ objs,
                                           int s, int end,
                                           const drt::Ray& r, float time,
                                           bool mb, float* t) {
  int typ[kU], eff[kU];
  const float* row[kU];
  int real = -1;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    row[u] = objs + (size_t)min(s + u, end - 1) * kSlotWidth;
    typ[u] = s + u < end ? __float_as_int(__ldg(row[u] + 12)) : -1;
    real = max(real, typ[u]);
  }
  if (real < 0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) t[u] = drt::kFltMax;
    return;
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) eff[u] = typ[u] < 0 ? real : typ[u];
  drt::prim_t_n<true, kU>(eff, row, r, time, mb, t);
#pragma unroll
  for (int u = 0; u < kU; ++u)
    if (typ[u] < 0) t[u] = drt::kFltMax;
}

// The serial leaf fold: the slots [first, first + count) in order against
// the lane's best hit, strict <.
__device__ __forceinline__ void leaf_closest(const float* __restrict__ objs,
                                             int first, int count,
                                             const Lane& l, bool mb,
                                             float& bt, int& bslot) {
  const int end = first + count;
  for (int s = first; s < end; s += kU) {
    float t[kU];
    test_slots(objs, s, end, l.r, l.time, mb, t);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (t[u] < bt) {
        bt = t[u];
        bslot = s + u;
      }
    }
  }
}

__device__ __forceinline__ bool occludes(float t, float dist,
                                         bool grid_mode) {
  return grid_mode ? t < dist : t <= dist + drt::kEpsilon;
}

// Whether a slot of the leaf occludes the shadow ray (time 0).
__device__ __forceinline__ bool leaf_occluded(const float* __restrict__ objs,
                                              int first, int count,
                                              const Lane& l, bool mb,
                                              bool grid_mode) {
  const int end = first + count;
  for (int s = first; s < end; s += kU) {
    float t[kU];
    test_slots(objs, s, end, l.r, 0.0f, mb, t);
    bool h = false;
#pragma unroll
    for (int u = 0; u < kU; ++u) h = h || occludes(t[u], l.time, grid_mode);
    if (h) return true;
  }
  return false;
}

// Steps a lane's cursor (node, its record cur) through inner nodes and
// rejected boxes to the next leaf the lane must test: true with its slots
// [*first, *first + *count) and the cursor past it, or false at the end of
// the walk.  Closest hit prunes boxes whose entry t is not below bt.
template <bool kClosest>
__device__ __forceinline__ bool next_leaf(const float4* __restrict__ nodes,
                                          int n_nodes, const Lane& l,
                                          float bt, int& node, Rec& cur,
                                          int* first, int* count) {
  while (node < n_nodes) {
    const int cnt = rec_count(cur), link = rec_link(cur);
    const int skip = cnt > 0 ? node + 1 : link;
    float tent;
    const bool ok = slab(l, cur, &tent);
    const bool visit = kClosest ? ok && tent < bt : ok;
    if (visit && cnt > 0) {
      *first = link;
      *count = cnt;
      node = skip;
      cur = load_rec(nodes, min(node, n_nodes - 1));
      return true;
    }
    node = visit ? node + 1 : skip;
    cur = load_rec(nodes, min(node, n_nodes - 1));
  }
  return false;
}

__device__ __forceinline__ void write_closest(int i, int n, float bt,
                                              int gid, const float* nrm,
                                              float* out_f, int* out_i) {
  const size_t N = n;
  out_f[i] = bt;
  out_f[N + i] = nrm[0];
  out_f[2 * N + i] = nrm[1];
  out_f[3 * N + i] = nrm[2];
  out_i[i] = gid;
}

// The winner's id and normal (none: -1 and 0) from its slot, then the
// lane's row.
__device__ __forceinline__ void finish_closest(const float* __restrict__ objs,
                                               const Lane& l, bool mb,
                                               int lane, int n, float bt,
                                               int bslot, float* out_f,
                                               int* out_i) {
  float nrm[3] = {0.0f, 0.0f, 0.0f};
  int gid = -1;
  if (bslot >= 0) {
    const float* row = objs + (size_t)bslot * kSlotWidth;
    gid = __float_as_int(__ldg(row + 13));
    drt::prim_normal(__float_as_int(__ldg(row + 12)), l.r, row, bt, l.time,
                     mb, nrm);
  }
  write_closest(lane, n, bt, gid, nrm, out_f, out_i);
}

// Whether this thread's lane is one to walk; a thread on an invalid lane
// writes that lane's miss row.
template <typename WriteMiss>
__device__ __forceinline__ bool valid_lane(const float* __restrict__ rays,
                                           int n, int lane,
                                           WriteMiss write_miss) {
  if (lane >= n) return false;
  const bool valid = rays[7 * (size_t)n + lane] != 0.0f;
  if (!valid) write_miss(lane);
  return valid;
}

// A thread walks its lane leaf by leaf (next_leaf); before each round of
// leaf tests the warp's walking threads (`warp`, balloted while every
// thread of the warp is there) vote, so that the lanes holding a leaf test
// it together, and the loop ends when none of them walks.
__device__ __forceinline__ void closest_walk(
    const float4* __restrict__ nodes, int n_nodes,
    const float* __restrict__ objs, const float* __restrict__ rays, int n,
    int motion_blur, float* __restrict__ out_f, int* __restrict__ out_i) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool live = valid_lane(rays, n, lane, [&](int i) {
    const float zero[3] = {0.0f, 0.0f, 0.0f};
    write_closest(i, n, drt::kFltMax, -1, zero, out_f, out_i);
  });
  const unsigned warp = __ballot_sync(kFullMask, live);
  if (!live) return;
  const bool mb = motion_blur != 0;
  const Lane l = load_lane(rays, n, lane);
  float bt = drt::kFltMax;
  int bslot = -1, first, count, node = 0;
  Rec cur = root_rec(nodes, n_nodes);
  for (bool walking = true;;) {
    if (walking)
      walking = next_leaf<true>(nodes, n_nodes, l, bt, node, cur, &first,
                                &count);
    if (!__any_sync(warp, walking)) break;  // leaf tests start together
    if (walking) leaf_closest(objs, first, count, l, mb, bt, bslot);
  }
  finish_closest(objs, l, mb, lane, n, bt, bslot, out_f, out_i);
}

// The shadow walks, as closest_walk; a walk ends at its first occluder.
// No t-pruning (bvh.cpp:347-387).
__device__ __forceinline__ void shadow_walk(
    const float4* __restrict__ nodes, int n_nodes,
    const float* __restrict__ objs, const float* __restrict__ rays, int n,
    int motion_blur, int grid_mode, unsigned char* __restrict__ occ) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool live = valid_lane(rays, n, lane, [&](int i) { occ[i] = 0; });
  const unsigned warp = __ballot_sync(kFullMask, live);
  if (!live) return;
  const bool mb = motion_blur != 0, gm = grid_mode != 0;
  const Lane l = load_lane(rays, n, lane);
  bool hit = false;
  int first, count, node = 0;
  Rec cur = root_rec(nodes, n_nodes);
  for (bool walking = true;;) {
    if (walking)
      walking = next_leaf<false>(nodes, n_nodes, l, 0.0f, node, cur, &first,
                                 &count);
    if (!__any_sync(warp, walking)) break;
    if (walking) {
      hit = leaf_occluded(objs, first, count, l, mb, gm);
      walking = !hit;
    }
  }
  occ[lane] = hit ? 1 : 0;
}

// K7 on its grouped tables, K8 on its threaded ones: one walk under two
// symbols, so that a profile tells the two apart.
__global__ void __launch_bounds__(kThreads) grouped_closest_kernel(
    const float4* __restrict__ nodes, int n_nodes,
    const float* __restrict__ objs, const float* __restrict__ rays, int n,
    int motion_blur, float* __restrict__ out_f, int* __restrict__ out_i) {
  closest_walk(nodes, n_nodes, objs, rays, n, motion_blur, out_f, out_i);
}

__global__ void __launch_bounds__(kThreads) legacy_closest_kernel(
    const float4* __restrict__ nodes, int n_nodes,
    const float* __restrict__ objs, const float* __restrict__ rays, int n,
    int motion_blur, float* __restrict__ out_f, int* __restrict__ out_i) {
  closest_walk(nodes, n_nodes, objs, rays, n, motion_blur, out_f, out_i);
}

__global__ void __launch_bounds__(kThreads) grouped_shadow_kernel(
    const float4* __restrict__ nodes, int n_nodes,
    const float* __restrict__ objs, const float* __restrict__ rays, int n,
    int motion_blur, int grid_mode, unsigned char* __restrict__ occ) {
  shadow_walk(nodes, n_nodes, objs, rays, n, motion_blur, grid_mode, occ);
}

__global__ void __launch_bounds__(kThreads) legacy_shadow_kernel(
    const float4* __restrict__ nodes, int n_nodes,
    const float* __restrict__ objs, const float* __restrict__ rays, int n,
    int motion_blur, int grid_mode, unsigned char* __restrict__ occ) {
  shadow_walk(nodes, n_nodes, objs, rays, n, motion_blur, grid_mode, occ);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// walk: 0 = K7's tables, 1 = K8's (the same walk, under its own symbol).
extern "C" int drt_packet_closest(const void* nodes, int n_nodes,
                                  const void* objs, const void* rays, int n,
                                  int motion_blur, int walk, void* out_f,
                                  void* out_i, void* stream) {
  if (n > 0) {
    auto k = walk == 0 ? grouped_closest_kernel : legacy_closest_kernel;
    k<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(nodes), n_nodes,
        static_cast<const float*>(objs), static_cast<const float*>(rays), n,
        motion_blur, static_cast<float*>(out_f), static_cast<int*>(out_i));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int drt_packet_shadow(const void* nodes, int n_nodes,
                                 const void* objs, const void* rays, int n,
                                 int motion_blur, int walk, int grid_mode,
                                 void* occ, void* stream) {
  if (n > 0) {
    auto k = walk == 0 ? grouped_shadow_kernel : legacy_shadow_kernel;
    k<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(nodes), n_nodes,
        static_cast<const float*>(objs), static_cast<const float*>(rays), n,
        motion_blur, grid_mode, static_cast<unsigned char*>(occ));
  }
  return static_cast<int>(cudaGetLastError());
}
