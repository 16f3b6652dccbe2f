"""SAH BVH: host build, threading, leaf collapse and the plain packet walk.

Counterpart of ``distributionraytracer_tpu.accel.bvh``.  The build (NumPy,
or ``native/`` through :mod:`distributionraytracer_tpu_torch.native`)
mirrors ``BVH::build_recursive`` (bvh.cpp:62-227): 12-bucket SAH over all
three axes with per-axis centroid sorts, leaf threshold 2, a fallback leaf
when the split is invalid or costs at least ``n``; children are appended
contiguously (``right = left + 1``).  :func:`thread_bvh` renumbers the tree
in DFS pre-order with skip links, :func:`collapse_leaves` turns subtrees of
at most ``max_leaf`` objects into single leaves.

:func:`threaded_walk` is the stackless walk of the threaded tree as a
batched torch loop, the plain version of the packet kernels K7 and K8 (they
compute the same function on their own tables, :class:`PacketTables`).
Each step a lane either tests its node's box (descend to ``node + 1`` or
jump to ``skip``) or one object of its leaf.  Reference semantics kept
(bvh.cpp:231-391): closest-hit pruning ``entry_t < best_t``, the inside-box
``t := 0`` fix, shadow any-hit ``t <= dist + EPSILON`` (or the grid's strict
``t < dist``) with a per-lane stop, shadow rays at time 0, no shadow
self-exclusion.  Objects of a leaf are tested in DFS order with a strict
``<``, so the first object wins a tie.

The JAX package's XLA traversals, in plain torch on any device (the route
``RenderConfig(accel_backend='traversal')`` selects, and the differentiable
base of ``parallel.mesh.accel_intersectors`` on a :class:`ThreadedBVH`):

- :func:`make_threaded_intersectors`: the stackless walk of the *full*
  (uncollapsed) threaded tree, :func:`threaded_walk` over its K8-layout
  tables;
- :func:`make_bvh_intersectors`: the reference's stack walk
  (bvh.cpp:231-391) with near-child-first order and pruned pops, a
  cross-check that only tests use.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from distributionraytracer_tpu_torch import native
from distributionraytracer_tpu_torch.accel.grid import object_bboxes
from distributionraytracer_tpu_torch.ops.common import EPSILON, FLT_MAX
from distributionraytracer_tpu_torch.ops.intersect import (
    HitResult, hit_packed,
)
from distributionraytracer_tpu_torch.scene.types import (
    OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, OBJ_TRIANGLE, SceneData,
)
from distributionraytracer_tpu_torch.utils import spans

STACK_SIZE = 64
LEAF_THRESHOLD = 2
BUCKETS = 12


class BVHArrays(NamedTuple):
    node_min: np.ndarray  # (N,3) f32
    node_max: np.ndarray  # (N,3) f32
    node_leaf: np.ndarray  # (N,) bool
    node_index: np.ndarray  # (N,) i32: left child, or first-object offset
    node_nobjs: np.ndarray  # (N,) i32
    obj_order: np.ndarray  # (O,) i32: leaf ranges index this permutation


def _area(lo, hi):
    e = hi - lo
    return 2.0 * (e[0] * e[1] + e[0] * e[2] + e[1] * e[2])


def build_bvh(scene: SceneData, use_native: bool = True,
              bboxes=None) -> BVHArrays:
    """SAH build over the objects' AABBs, or over ``bboxes`` (O, 2, 3)
    when given (the grid emulation builds over its own boxes)."""
    bb32 = (object_bboxes(scene) if bboxes is None
            else np.asarray(bboxes, np.float32))
    if use_native:
        res = native.build_bvh_native(bb32[:, 0], bb32[:, 1])
        if res is not None:
            nmin, nmax, leaf, index, nobjs, order = res
            return BVHArrays(np.asarray(nmin, np.float32),
                             np.asarray(nmax, np.float32),
                             np.asarray(leaf, bool), np.asarray(index, np.int32),
                             np.asarray(nobjs, np.int32),
                             np.asarray(order, np.int32))
    bb = bb32.astype(np.float64)
    O = bb.shape[0]
    centroids = (bb[:, 0] + bb[:, 1]) / 2.0
    order = np.arange(O, dtype=np.int64)  # permutation sorted in place
    node_min = [bb[:, 0].min(0) - EPSILON]
    node_max = [bb[:, 1].max(0) + EPSILON]
    node_leaf, node_index, node_nobjs = [False], [0], [0]

    def make_leaf(node, left, n):
        node_leaf[node] = True
        node_index[node] = left
        node_nobjs[node] = n

    def recurse(left, right, node):
        n = right - left
        if n <= LEAF_THRESHOLD:
            make_leaf(node, left, n)
            return
        box_lo, box_hi = node_min[node], node_max[node]
        parent_area = _area(box_lo, box_hi)
        best_cost, best_axis, best_split = np.inf, 0, left
        for axis in range(3):
            seg = order[left:right]
            # std::sort by centroid (bvh.cpp:88-92); stable here
            seg_sorted = seg[np.argsort(centroids[seg, axis], kind="stable")]
            order[left:right] = seg_sorted
            lo_b, hi_b = box_lo[axis], box_hi[axis]
            scale = BUCKETS / (hi_b - lo_b) if hi_b - lo_b > 0 else 0.0
            idx = np.minimum(BUCKETS - 1,
                             ((centroids[seg_sorted, axis] - lo_b) * scale)
                             .astype(np.int64))
            counts = np.bincount(idx, minlength=BUCKETS)
            bmin = np.full((BUCKETS, 3), np.inf)
            bmax = np.full((BUCKETS, 3), -np.inf)
            for b in range(BUCKETS):
                sel = seg_sorted[idx == b]
                if len(sel):
                    bmin[b] = bb[sel, 0].min(0)
                    bmax[b] = bb[sel, 1].max(0)
            # empty buckets carry +-inf bounds; their nan costs never win,
            # as the C++'s FLT_MAX arithmetic (bvh.cpp:95-188)
            np_err = np.seterr(invalid="ignore")
            for i in range(1, BUCKETS):
                lc, rc = counts[:i].sum(), counts[i:].sum()
                cost = 1.0 + (lc * _area(bmin[:i].min(0), bmax[:i].max(0))
                              + rc * _area(bmin[i:].min(0), bmax[i:].max(0))
                              ) / parent_area
                if cost < best_cost:
                    best_cost, best_axis, best_split = cost, axis, left + int(lc)
            np.seterr(**np_err)
        if (best_split <= left or best_split >= right
                or best_cost >= float(n)):
            make_leaf(node, left, n)  # fallback leaf (bvh.cpp:193-196)
            return
        seg = order[left:right]  # re-sort on the best axis (bvh.cpp:198-201)
        order[left:right] = seg[np.argsort(centroids[seg, best_axis],
                                           kind="stable")]
        li = len(node_min)
        node_index[node] = li
        for sel in (order[left:best_split], order[best_split:right]):
            node_min.append(bb[sel, 0].min(0))
            node_max.append(bb[sel, 1].max(0))
            node_leaf.append(False)
            node_index.append(0)
            node_nobjs.append(0)
        recurse(left, best_split, li)
        recurse(best_split, right, li + 1)

    old_lim = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_lim, 100000))
    try:
        recurse(0, O, 0)
    finally:
        sys.setrecursionlimit(old_lim)
    return BVHArrays(
        node_min=np.stack(node_min).astype(np.float32),
        node_max=np.stack(node_max).astype(np.float32),
        node_leaf=np.array(node_leaf, bool),
        node_index=np.array(node_index, np.int32),
        node_nobjs=np.array(node_nobjs, np.int32),
        obj_order=order.astype(np.int32))


class ThreadedBVH(NamedTuple):
    """DFS pre-order node tables with skip links (NumPy).

    ``node_box`` (N, 6) f32 [min, max]; ``node_meta`` (N, 4) i32 [skip,
    first_or_left, n_objs, is_leaf]; ``obj_order`` as in BVHArrays.  A
    node's left child is ``node + 1``; ``skip`` jumps past its subtree;
    ``node == N`` ends a walk.
    """

    node_box: np.ndarray
    node_meta: np.ndarray
    obj_order: np.ndarray


def thread_bvh(bvh: BVHArrays) -> ThreadedBVH:
    """Renumber a BVHArrays tree in DFS pre-order and add skip links."""
    leaf = np.asarray(bvh.node_leaf)
    index = np.asarray(bvh.node_index, np.int64)
    nobjs = np.asarray(bvh.node_nobjs, np.int64)
    N = leaf.shape[0]
    # subtree sizes: children have larger ids than their parent
    # (bvh.cpp:206-222), so one reverse sweep suffices
    size = np.ones(N, np.int64)
    for i in range(N - 1, -1, -1):
        if not leaf[i]:
            size[i] = 1 + size[index[i]] + size[index[i] + 1]
    # iterative pre-order: the left child is pushed last, popped first
    order_old = np.empty(N, np.int64)
    stack, c = [0], 0
    while stack:
        o = stack.pop()
        order_old[c] = o
        c += 1
        if not leaf[o]:
            stack.append(index[o] + 1)
            stack.append(index[o])
    assert c == N
    box = np.concatenate([np.asarray(bvh.node_min, np.float32)[order_old],
                          np.asarray(bvh.node_max, np.float32)[order_old]],
                         axis=1)
    meta = np.stack([np.arange(N, dtype=np.int64) + size[order_old],
                     index[order_old], nobjs[order_old],
                     leaf[order_old].astype(np.int64)], axis=1)
    return ThreadedBVH(box.astype(np.float32), meta.astype(np.int32),
                       np.asarray(bvh.obj_order, np.int32))


def protect_mask(scene: SceneData, motion_blur: bool = False) -> np.ndarray:
    """Objects whose hits can escape their own AABB: infinite planes
    always; spheres when motion blur moves them out of their static boxes
    (scene.cpp:158-162)."""
    types = np.array(scene.static.obj_types, np.int64)
    p = types == OBJ_PLANE
    if motion_blur:
        p = p | (types == OBJ_SPHERE)
    return p


def collapse_leaves(tb: ThreadedBVH, max_leaf: int,
                    protect=None) -> ThreadedBVH:
    """Subtrees holding at most ``max_leaf`` objects become single leaves.

    ``protect`` (bool (O,), by original object id) marks objects whose hits
    can escape their AABB (:func:`protect_mask`); a subtree holding one is
    never collapsed, since the collapsed leaf would test it whenever the
    merged box is hit.  Winners are unchanged otherwise: a collapsed leaf
    tests its subtree's objects in DFS order with the same strict ``<``,
    and every object a per-lane walk could reach stays reachable.  Relies
    on ``obj_order`` being DFS-contiguous (asserted).
    """
    box = np.asarray(tb.node_box, np.float32)
    meta = np.asarray(tb.node_meta, np.int64)
    N = box.shape[0]
    skip, first, nobjs = meta[:, 0], meta[:, 1], meta[:, 2]
    cnt_prefix = np.zeros(N + 1, np.int64)  # objects before node i
    np.cumsum(nobjs, out=cnt_prefix[1:])
    oorder = np.asarray(tb.obj_order, np.int64)
    prot_prefix = np.zeros(len(oorder) + 1, np.int64)
    if protect is not None and len(oorder):
        np.cumsum(np.asarray(protect, bool)[oorder].astype(np.int64),
                  out=prot_prefix[1:])
    lf = nobjs > 0
    assert (first[lf] == cnt_prefix[:-1][lf]).all(), \
        "obj_order is not DFS-contiguous"
    new_box, new_meta, old2new = [], [], np.full(N + 1, -1, np.int64)
    i = 0
    while i < N:
        sub_count = cnt_prefix[skip[i]] - cnt_prefix[i]
        sub_prot = (prot_prefix[cnt_prefix[skip[i]]]
                    - prot_prefix[cnt_prefix[i]])
        old2new[i] = len(new_meta)
        new_box.append(box[i])
        if nobjs[i] == 0 and 0 < sub_count <= max_leaf and sub_prot == 0:
            new_meta.append([skip[i], cnt_prefix[i], sub_count, 1])
            i = skip[i]
        else:
            new_meta.append([skip[i], first[i], nobjs[i],
                             1 if nobjs[i] else 0])
            i += 1
    old2new[N] = len(new_meta)
    nb = np.asarray(new_box, np.float32)
    nm = np.asarray(new_meta, np.int64)
    assert (old2new[nm[:, 0]] >= 0).all()  # every skip target survives
    nm[:, 0] = old2new[nm[:, 0]]
    return ThreadedBVH(nb, nm.astype(np.int32),
                       np.asarray(tb.obj_order, np.int32))


# ------------------------------------------------------------- packet tables
class PacketTables(NamedTuple):
    """A threaded tree as the packet kernels read it.

    ``nodes`` (N, 8) f32, two 16-byte records per node: ``[bmin xyz, link]``
    and ``[bmax xyz, slot_count]``, the ints stored as int32 bits.  An inner
    node (slot count 0) links to its skip target; a leaf links to its first
    slot, and its skip target is ``node + 1`` (in DFS pre-order a leaf's
    subtree is the leaf alone).  ``objs`` (S, 16) f32, one 64-byte record
    per object slot: ``[12 packed parameters (SceneData.packed_objects),
    type, object id, 0, 0]``, type and id as int32 bits; type -1 marks an
    inert slot.  ``kind`` is ``grouped`` (K7: slots in 8-aligned object
    groups) or ``threaded`` (K8: slots in ``obj_order``).
    """

    kind: str
    nodes: torch.Tensor
    objs: torch.Tensor

    def to(self, device) -> "PacketTables":
        return PacketTables(self.kind, self.nodes.to(device),
                            self.objs.to(device))

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]


INT32_MAX = (1 << 31) - 1


def pack_nodes(box: np.ndarray, skip, first_slot, slot_count) -> np.ndarray:
    """(N, 8) f32 node records (:class:`PacketTables`).  Any tree whose
    node and slot numbers fit in int32 packs."""
    N = box.shape[0]
    skip = np.asarray(skip, np.int64)
    first_slot = np.asarray(first_slot, np.int64)
    slot_count = np.asarray(slot_count, np.int64)
    leaf = slot_count > 0
    if not (skip[leaf] == np.nonzero(leaf)[0] + 1).all():
        raise ValueError("a leaf's skip link is not the next node: the "
                         "tree is not in DFS pre-order")
    link = np.where(leaf, first_slot, skip)
    if N and (N > INT32_MAX or (link + slot_count).max() > INT32_MAX):
        raise ValueError("tree too large for int32 node records")
    out = np.zeros((N, 8), np.float32)
    out[:, 0:3] = box[:, 0:3]
    out[:, 4:7] = box[:, 3:6]
    ints = out.view(np.int32)
    ints[:, 3] = link
    ints[:, 7] = slot_count
    return out


def pack_slots(obj_data: np.ndarray, obj_types: np.ndarray,
               ids: np.ndarray) -> np.ndarray:
    """(S, 16) f32 object records for slot ids (-1: inert)."""
    ids = np.asarray(ids, np.int64)
    live = ids >= 0
    out = np.zeros((ids.shape[0], 16), np.float32)
    out[live, 0:12] = obj_data[ids[live]]
    ints = out.view(np.int32)
    ints[:, 12] = np.where(live, np.asarray(obj_types)[np.maximum(ids, 0)],
                           -1)
    ints[:, 13] = np.where(live, ids, -1)
    return out


def node_fields(nodes: torch.Tensor):
    """(bmin, bmax, skip, first_slot, slot_count) of packed node records."""
    ints = nodes.view(torch.int32)
    link, count = ints[:, 3].long(), ints[:, 7].long()
    leaf = count > 0
    nxt = torch.arange(1, nodes.shape[0] + 1, device=nodes.device)
    return (nodes[:, 0:3], nodes[:, 4:7], torch.where(leaf, nxt, link),
            torch.where(leaf, link, torch.zeros_like(link)), count)


def _slab(o, inv, lo, hi):
    """Entry-t slab test (boundingBox.cpp:64-124) with the inside-box
    ``t := 0`` fix (bvh.cpp:256-257): (ok, entry t)."""
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    pos = inv >= 0.0
    t0 = torch.where(pos, ta, tb).amax(-1)
    t1 = torch.where(pos, tb, ta).amin(-1)
    tent = torch.where(t0 < 0.0, t1, t0)
    inside = ((o > lo) & (o < hi)).all(-1)
    return (t0 < t1) & (t1 > 0.0), torch.where(inside, torch.zeros_like(tent),
                                               tent)


def threaded_walk(tabs: PacketTables, o, d, time, valid=None,
                  shadow_dist=None, shadow_mode: str = "bvh",
                  motion_blur: bool = False, types_present=None,
                  stats: Optional[dict] = None):
    """The per-lane stackless walk (plain version of K7 and K8).

    Closest hit (``shadow_dist`` None): returns ``(t, normal, obj_id)``,
    t = FLT_MAX and id -1 on a miss.  Shadow: returns occluded (R,) bool;
    ``shadow_mode`` ``bvh`` accepts ``t <= dist + EPSILON``, ``grid``
    ``t < dist``.  Lanes with ``valid`` false do nothing.  ``stats``, when
    given, receives the node tests and object tests the walk did (the
    kernels' work on these inputs): ``node_tests``, ``obj_tests`` and
    ``type_tests``, the object tests by slot type (index type + 1, so 0
    counts inert slots)."""
    is_shadow = shadow_dist is not None
    if types_present is None:
        types_present = (OBJ_SPHERE, OBJ_TRIANGLE, OBJ_PLANE, OBJ_BOX)
    dev = o.device
    R = o.shape[0]
    N = tabs.n_nodes
    bmin, bmax, skip, first, count = node_fields(tabs.nodes)
    oints = tabs.objs.view(torch.int32)
    otype, ogid = oints[:, 12], oints[:, 13]
    inv = 1.0 / d
    if is_shadow:
        time = torch.zeros((R,), dtype=torch.float32, device=dev)

    node = torch.zeros((R,), dtype=torch.long, device=dev)
    if valid is not None:
        node = torch.where(valid, node, torch.full_like(node, N))
    k = torch.full((R,), -1, dtype=torch.long, device=dev)
    best_t = torch.full((R,), FLT_MAX, dtype=torch.float32, device=dev)
    best_n = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    best_id = torch.full((R,), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros((R,), dtype=torch.bool, device=dev)
    node_tests = obj_tests = 0
    type_tests = torch.zeros((5,), dtype=torch.int64, device=dev)

    act = torch.nonzero(node < N).squeeze(1)
    # a DFS visits each node once and tests each slot once: a bound that a
    # corrupted skip link cannot loop past
    for _ in range(N + tabs.objs.shape[0] + 64):
        if act.numel() == 0:
            break
        nd, kk = node[act], k[act]
        in_leaf = kk >= 0
        li, ni = act[in_leaf], act[~in_leaf]
        lnd, nnd = nd[in_leaf], nd[~in_leaf]
        # ---- one leaf object for lanes inside a leaf ----
        if li.numel():
            slot = first[lnd] + kk[in_leaf]
            row = tabs.objs[slot]
            t, nrm = hit_packed(o[li], d[li], time[li], row, otype[slot],
                                motion_blur, types_present)
            obj_tests += li.numel()
            if stats is not None:
                type_tests += torch.bincount(otype[slot].long() + 1,
                                             minlength=5)
            if is_shadow:
                sd = shadow_dist[li]
                hit_now = (t < sd) if shadow_mode == "grid" else (
                    t <= sd + EPSILON)
                occ[li] = occ[li] | hit_now
            else:
                better = t < best_t[li]
                best_t[li] = torch.where(better, t, best_t[li])
                best_n[li] = torch.where(better[:, None], nrm, best_n[li])
                best_id[li] = torch.where(better, ogid[slot], best_id[li])
            k2 = kk[in_leaf] + 1
            done = k2 >= count[lnd]
            new_node = torch.where(done, skip[lnd], lnd)
            if is_shadow:
                new_node = torch.where(occ[li], torch.full_like(new_node, N),
                                       new_node)
            node[li] = new_node
            k[li] = torch.where(done, torch.full_like(k2, -1), k2)
        # ---- one node box for the other lanes ----
        if ni.numel():
            ok, tent = _slab(o[ni], inv[ni], bmin[nnd], bmax[nnd])
            node_tests += ni.numel()
            visit = ok if is_shadow else ok & (tent < best_t[ni])
            leaf = count[nnd] > 0
            node[ni] = torch.where(visit & ~leaf, nnd + 1,
                                   torch.where(visit & leaf, nnd, skip[nnd]))
            k[ni] = torch.where(visit & leaf, 0, -1)
        act = act[node[act] < N]
    else:
        raise RuntimeError("threaded walk did not end: corrupted skip links")
    if stats is not None:
        stats["node_tests"] = stats.get("node_tests", 0) + node_tests
        stats["obj_tests"] = stats.get("obj_tests", 0) + obj_tests
        stats["type_tests"] = stats.get("type_tests", 0) + type_tests.cpu()
    if is_shadow:
        return occ
    return best_t, best_n, best_id


def hit_result(t, normal, gid, mats) -> HitResult:
    """A HitResult from a walk's (t, normal, object id)."""
    hit = gid >= 0
    return HitResult(hit=hit, t=torch.where(hit, t, torch.full_like(t,
                                                                    FLT_MAX)),
                     normal=normal, obj_id=gid,
                     mat_id=mats[torch.clamp(gid, min=0).long()])


# ------------------------------------------------------ XLA-shaped traversals
def make_threaded_intersectors(scene: SceneData, tb: ThreadedBVH,
                               motion_blur: bool = False):
    """The stackless walk of the full threaded tree ``tb`` in plain torch:
    :func:`threaded_walk` (closest hits pruned by ``entry_t < best_t``,
    shadows ``t <= dist + EPSILON``, no self-exclusion) over ``tb`` packed
    in K8's layout with no leaf collapse, on the scene's device."""
    from distributionraytracer_tpu_torch.accel.cuda_bvh import (
        pack_threaded, packet_intersectors,
    )
    tabs = pack_threaded(scene, tb).to(scene.device)
    return packet_intersectors(scene, tabs, motion_blur, plain=True)


def make_bvh_intersectors(scene: SceneData, bvh: BVHArrays,
                          motion_blur: bool = False):
    """The reference's stack traversal (bvh.cpp:231-391), batched over rays
    with each finished lane frozen, as the JAX package's vmapped
    ``while_loop`` is: near child first (closest: ``tL < tR``; shadow:
    ``tL <= tR``), the far child pushed on a 64-entry stack with its entry
    t, pops pruned by ``t < best_t`` (closest) and a shadow lane stopping
    at its first ``t <= dist + EPSILON``.  ``valid`` is ignored."""
    from distributionraytracer_tpu_torch.integrator.whitted import (
        Intersectors,
    )
    dev = scene.device
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                         device=dev)
    nmin = as_t(bvh.node_min, torch.float32)
    nmax = as_t(bvh.node_max, torch.float32)
    nleaf = as_t(bvh.node_leaf, torch.bool)
    nindex = as_t(bvh.node_index, torch.int64)
    nnobjs = as_t(bvh.node_nobjs, torch.int64)
    oorder = as_t(bvh.obj_order, torch.int64)
    data, types, mats = scene.packed_objects()
    n_nodes = nmin.shape[0]
    max_leaf = int(nnobjs.max()) if n_nodes else 0
    # each step enters a new node or finishes a leaf and pops: a walk
    # visits each node at most twice
    bound = 2 * n_nodes + 64

    def _walk(o, d, time, dist=None):
        is_shadow = dist is not None
        R = o.shape[0]
        inv = 1.0 / d
        lanes = torch.arange(R, device=o.device)
        root_ok, _ = _slab(o, inv, nmin[0], nmax[0])
        zero = torch.zeros((R,), dtype=torch.int64, device=o.device)
        s = dict(node=zero, sp=zero,
                 stack_n=torch.zeros((R, STACK_SIZE), dtype=torch.int64,
                                     device=o.device),
                 stack_t=torch.zeros((R, STACK_SIZE), dtype=torch.float32,
                                     device=o.device),
                 best_t=torch.full((R,), FLT_MAX, dtype=torch.float32,
                                   device=o.device),
                 best_n=torch.zeros((R, 3), dtype=torch.float32,
                                    device=o.device),
                 best_obj=zero - 1, occluded=torch.zeros_like(root_ok),
                 active=root_ok)
        for _ in range(bound):
            act = s["active"]
            spans.host_read(act)
            if not bool(act.any()):
                break
            node, sp = s["node"], s["sp"]
            leaf = nleaf[node]
            # ---- inner node: both children's boxes ----
            li = torch.clamp(torch.where(leaf, 1, nindex[node]), 0,
                             max(n_nodes - 2, 0))
            ri = torch.clamp(li + 1, max=n_nodes - 1)
            okL, tL = _slab(o, inv, nmin[li], nmax[li])
            okR, tR = _slab(o, inv, nmin[ri], nmax[ri])
            both = okL & okR
            # closest a strict <, shadow <= (bvh.cpp:261 vs 347)
            lf = both & ((tL <= tR) if is_shadow else (tL < tR))
            near = torch.where(lf, li, ri)
            far = torch.where(lf, ri, li)
            far_t = torch.where(lf, tR, tL)
            next_inner = torch.where(both, near, torch.where(okL, li, ri))
            descend = (both | (okL ^ okR)) & ~leaf
            push = both & ~leaf & (sp < STACK_SIZE)  # a full stack drops it
            slot = torch.clamp(sp, max=STACK_SIZE - 1)
            stack_n, stack_t = s["stack_n"].clone(), s["stack_t"].clone()
            stack_n[lanes, slot] = torch.where(push, far,
                                               stack_n[lanes, slot])
            stack_t[lanes, slot] = torch.where(push, far_t,
                                               stack_t[lanes, slot])
            sp2 = torch.where(both & ~leaf, sp + 1, sp)
            # ---- leaf: its objects in order ----
            bt, bn, bo, occ = (s["best_t"], s["best_n"], s["best_obj"],
                               s["occluded"])
            nobj, first = nnobjs[node], nindex[node]
            for i in range(max_leaf):
                m = leaf & (i < nobj)
                gid = oorder[torch.clamp(first + i, 0, oorder.shape[0] - 1)]
                t, nrm = hit_packed(o, d, time, data[gid], types[gid],
                                    motion_blur)
                if is_shadow:
                    occ = occ | (m & (t <= dist + EPSILON))
                    continue
                better = m & (t < bt)
                bt = torch.where(better, t, bt)
                bn = torch.where(better[:, None], nrm, bn)
                bo = torch.where(better, gid, bo)
            # ---- pop: after a leaf, or an inner node with no child hit;
            # closest pops skip entries with t >= best_t (bvh.cpp:299-311)
            need_pop = leaf | ~descend
            psp, pnode, found = sp2, node, ~need_pop
            while True:
                go = ~found & (psp > 0)
                spans.host_read(go)
                if not bool(go.any()):
                    break
                top = torch.clamp(psp - 1, 0, STACK_SIZE - 1)
                cand = stack_n[lanes, top]
                good = (torch.ones_like(go) if is_shadow
                        else stack_t[lanes, top] < bt)
                psp = torch.where(go, psp - 1, psp)
                pnode = torch.where(go & good, cand, pnode)
                found = torch.where(go, good, found)
            new = dict(node=torch.where(need_pop, pnode,
                                        torch.where(leaf, node, next_inner)),
                       sp=torch.where(need_pop, psp, sp2),
                       stack_n=stack_n, stack_t=stack_t, best_t=bt,
                       best_n=bn, best_obj=bo, occluded=occ)
            done = need_pop & ~found
            if is_shadow:
                done = done | occ
            new["active"] = act & ~done
            s = {k: torch.where(act.reshape((-1,) + (1,) * (v.dim() - 1)),
                                v, s[k]) for k, v in new.items()}
        else:
            raise RuntimeError("stack BVH walk did not end")
        if is_shadow:
            return s["occluded"]
        hit = s["best_obj"] >= 0
        return (hit, torch.where(hit, s["best_t"],
                                 torch.full_like(s["best_t"], FLT_MAX)),
                s["best_n"], s["best_obj"])

    def closest(o, d, time, valid=None):
        del valid  # the per-ray walk answers every lane
        hit, t, nrm, gid = _walk(o, d, time)
        return HitResult(hit=hit, t=t, normal=nrm,
                         obj_id=gid.to(torch.int32),
                         mat_id=mats[torch.clamp(gid, min=0)])

    def shadow(o, d, dist, exclude_obj, valid=None):
        del exclude_obj, valid  # no self-exclusion (bvh.cpp:376)
        return _walk(o, d, torch.zeros_like(dist), dist=dist)

    return Intersectors(closest, shadow)
