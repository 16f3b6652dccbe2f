// K7 grouped walk and K8 union walk: closest and any hit over a threaded,
// leaf-collapsed BVH.
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
// first occluder.
// Bound: for each lane, the node slab tests and object tests its walk makes
// (the plain walk counts them); FP32 ALU and dependent table loads.
// Design:
//   K7 (grouped): one thread per ray, its own cursor; a node is two float4
//     records read through __ldg; slots in 8-aligned object groups (inert
//     slots, type -1, are skipped).  A dead lane does nothing.
//   K8 (legacy): K8's own design mapped to a warp: the 32 lanes share one
//     cursor and enter a node iff __any_sync finds a live lane that wants it
//     (ok && entry_t < best_t); at a leaf every lane tests the objects under
//     its own vote, so each lane accepts exactly what its own walk would.
//     Child boxes lie inside their parent and entry t grows down the tree,
//     so a lane that did not want a node wants none below it
//     (pallas_bvh.py:11-24): the union walk equals the per-lane walk.
// Layouts (all contiguous):
//   nodes (N,8) f32 = N x {float4 [bmin xyz, link bits],
//                          float4 [bmax xyz, slot_count bits]},
//     link = the skip target of an inner node (slot_count 0), the first
//     slot of a leaf, whose skip target is node + 1 (DFS pre-order);
//   objs (S,16) f32 slot records [12 params, type bits, id bits, 0, 0];
//   rays (8,R) f32 rows ox oy oz dx dy dz time|dist valid;
//   closest out_f (4,R) f32 rows t nx ny nz, out_i (R,) i32 object id;
//   shadow occ (R,) u8.
// Each launch function returns cudaGetLastError().

#include "primitives.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSlotWidth = 16;
constexpr unsigned kFullMask = 0xffffffffu;

struct Node {
  float lo[3], hi[3];
  int skip, first, count;
};

__device__ __forceinline__ Node load_node(const float4* nodes, int i) {
  const float4 a = __ldg(nodes + 2 * i);
  const float4 b = __ldg(nodes + 2 * i + 1);
  const int link = __float_as_int(a.w);
  const int count = __float_as_int(b.w);
  return Node{{a.x, a.y, a.z}, {b.x, b.y, b.z}, count > 0 ? i + 1 : link,
              count > 0 ? link : 0, count};
}

// Entry-t slab test (boundingBox.cpp:64-124), NaN-propagating min/max as
// the plain version's amax/amin; entry t := 0 when the origin is inside.
__device__ __forceinline__ bool slab(const drt::Ray& r, const float inv[3],
                                     const Node& nd, float* tent) {
  const float o[3] = {r.ox, r.oy, r.oz};
  float t0 = 0.0f, t1 = 0.0f;
  bool inside = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ta = (nd.lo[k] - o[k]) * inv[k];
    const float tb = (nd.hi[k] - o[k]) * inv[k];
    const bool pos = inv[k] >= 0.0f;
    const float tn = pos ? ta : tb;
    const float tf = pos ? tb : ta;
    t0 = k == 0 ? tn : drt::max_nan(t0, tn);
    t1 = k == 0 ? tf : drt::min_nan(t1, tf);
    inside = inside && o[k] > nd.lo[k] && o[k] < nd.hi[k];
  }
  *tent = inside ? 0.0f : (t0 < 0.0f ? t1 : t0);
  return t0 < t1 && t1 > 0.0f;
}

struct Lane {
  drt::Ray r;
  float inv[3];
  float time;  // closest: the ray's time; shadow: the occluder distance
  bool valid;
};

__device__ __forceinline__ Lane load_lane(const float* rays, int n, int i) {
  Lane l{};
  if (i >= n) return l;
  const size_t N = n;
  l.r = drt::Ray{rays[i], rays[N + i], rays[2 * N + i], rays[3 * N + i],
                 rays[4 * N + i], rays[5 * N + i]};
  l.inv[0] = 1.0f / l.r.dx;
  l.inv[1] = 1.0f / l.r.dy;
  l.inv[2] = 1.0f / l.r.dz;
  l.time = rays[6 * N + i];
  l.valid = rays[7 * N + i] != 0.0f;
  return l;
}

// The slots of one leaf against one lane's best hit, in slot order.
__device__ __forceinline__ void leaf_closest(const float* objs,
                                             const Node& nd, const Lane& l,
                                             bool motion_blur, float* bt,
                                             int* gid, float* nrm) {
  for (int s = nd.first; s < nd.first + nd.count; ++s) {
    const float* row = objs + (size_t)s * kSlotWidth;
    const int typ = __float_as_int(__ldg(row + 12));
    if (typ < 0) continue;  // inert padding slot
    const float t = drt::prim_t(typ, l.r, row, l.time, motion_blur);
    if (t < *bt) {
      *bt = t;
      *gid = __float_as_int(__ldg(row + 13));
      drt::prim_normal(typ, l.r, row, t, l.time, motion_blur, nrm);
    }
  }
}

// True at the leaf's first occluder (shadow rays run at time 0).
__device__ __forceinline__ bool leaf_occluded(const float* objs,
                                              const Node& nd, const Lane& l,
                                              bool motion_blur,
                                              bool grid_mode) {
  for (int s = nd.first; s < nd.first + nd.count; ++s) {
    const float* row = objs + (size_t)s * kSlotWidth;
    const int typ = __float_as_int(__ldg(row + 12));
    if (typ < 0) continue;
    const float t = drt::prim_t(typ, l.r, row, 0.0f, motion_blur);
    if (grid_mode ? t < l.time : t <= l.time + drt::kEpsilon) return true;
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

// ---------------------------------------------------------------- K7
__global__ void grouped_closest_kernel(const float4* __restrict__ nodes,
                                       int n_nodes,
                                       const float* __restrict__ objs,
                                       const float* __restrict__ rays, int n,
                                       int motion_blur,
                                       float* __restrict__ out_f,
                                       int* __restrict__ out_i) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Lane l = load_lane(rays, n, i);
  float bt = drt::kFltMax, nrm[3] = {0.0f, 0.0f, 0.0f};
  int gid = -1;
  // the cursor only grows (node + 1 or skip > node): at most N steps
  for (int node = l.valid ? 0 : n_nodes; node < n_nodes;) {
    const Node nd = load_node(nodes, node);
    float tent;
    if (slab(l.r, l.inv, nd, &tent) && tent < bt) {
      if (nd.count == 0) {
        node = node + 1;
        continue;
      }
      leaf_closest(objs, nd, l, motion_blur != 0, &bt, &gid, nrm);
    }
    node = nd.skip;
  }
  write_closest(i, n, bt, gid, nrm, out_f, out_i);
}

__global__ void grouped_shadow_kernel(const float4* __restrict__ nodes,
                                      int n_nodes,
                                      const float* __restrict__ objs,
                                      const float* __restrict__ rays, int n,
                                      int motion_blur, int grid_mode,
                                      unsigned char* __restrict__ occ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Lane l = load_lane(rays, n, i);
  bool hit = false;
  for (int node = l.valid ? 0 : n_nodes; node < n_nodes && !hit;) {
    const Node nd = load_node(nodes, node);
    float tent;
    if (slab(l.r, l.inv, nd, &tent)) {  // no t-pruning (bvh.cpp:347-387)
      if (nd.count == 0) {
        node = node + 1;
        continue;
      }
      hit = leaf_occluded(objs, nd, l, motion_blur != 0, grid_mode != 0);
    }
    node = nd.skip;
  }
  occ[i] = hit ? 1 : 0;
}

// ---------------------------------------------------------------- K8
// Every thread of a warp runs the loop (lanes past n are dead), so the
// cursor and the __any_sync votes stay warp-uniform.
__global__ void legacy_closest_kernel(const float4* __restrict__ nodes,
                                      int n_nodes,
                                      const float* __restrict__ objs,
                                      const float* __restrict__ rays, int n,
                                      int motion_blur,
                                      float* __restrict__ out_f,
                                      int* __restrict__ out_i) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Lane l = load_lane(rays, n, i);
  float bt = drt::kFltMax, nrm[3] = {0.0f, 0.0f, 0.0f};
  int gid = -1;
  for (int node = 0; node < n_nodes;) {
    const Node nd = load_node(nodes, node);
    float tent;
    const bool vote = l.valid && slab(l.r, l.inv, nd, &tent) && tent < bt;
    if (!__any_sync(kFullMask, vote)) {
      node = nd.skip;
    } else if (nd.count == 0) {
      node = node + 1;
    } else {
      if (vote) leaf_closest(objs, nd, l, motion_blur != 0, &bt, &gid, nrm);
      node = nd.skip;
    }
  }
  if (i < n) write_closest(i, n, bt, gid, nrm, out_f, out_i);
}

__global__ void legacy_shadow_kernel(const float4* __restrict__ nodes,
                                     int n_nodes,
                                     const float* __restrict__ objs,
                                     const float* __restrict__ rays, int n,
                                     int motion_blur, int grid_mode,
                                     unsigned char* __restrict__ occ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Lane l = load_lane(rays, n, i);
  bool hit = false;
  // the warp stops once none of its live lanes is unoccluded
  for (int node = 0;
       node < n_nodes && __any_sync(kFullMask, l.valid && !hit);) {
    const Node nd = load_node(nodes, node);
    float tent;
    const bool vote = l.valid && !hit && slab(l.r, l.inv, nd, &tent);
    if (!__any_sync(kFullMask, vote)) {
      node = nd.skip;
    } else if (nd.count == 0) {
      node = node + 1;
    } else {
      if (vote)
        hit = leaf_occluded(objs, nd, l, motion_blur != 0, grid_mode != 0);
      node = nd.skip;
    }
  }
  if (i < n) occ[i] = hit ? 1 : 0;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// walk: 0 = K7 (one cursor per lane), 1 = K8 (one cursor per warp).
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
