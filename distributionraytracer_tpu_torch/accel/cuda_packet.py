"""Grouped packet traversal: K7, one walk per ray over grouped tables.

Counterpart of ``distributionraytracer_tpu.accel.pallas_packet``.
:func:`pack_grouped` packs a leaf-collapsed :class:`ThreadedBVH` so that
every leaf owns whole 8-object groups: leaves take consecutive groups in
DFS order, a leaf's objects fill its groups in ``obj_order`` and inert
slots (type -1) pad its last group.  The binned route (K9,
``accel/cuda_binned.py``) addresses these groups by number.  The JAX
package's refusals are kept, so a scene takes the same route in both: a
leaf over 64 objects, a multi-group leaf holding a protected object, a
node group of 8 whose leaves need more than ``REL_SLOTS`` object groups,
2^19 groups or more.  Its lane-column layout is not copied: the nodes are
the two 16-byte records of :class:`accel.bvh.PacketTables`.

``accel/cuda_bvh.py::packet_intersectors`` runs K7 (``csrc/bvh.cu``) over
these tables on CUDA tensors and the plain walk,
:func:`accel.bvh.threaded_walk`, on CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributionraytracer_tpu_torch.accel.bvh import (
    PacketTables, ThreadedBVH, pack_nodes, pack_slots, protect_mask,
)
from distributionraytracer_tpu_torch.accel.cuda_bvh import (
    packed_objects_np,
)
from distributionraytracer_tpu_torch.scene.types import SceneData

GROUP = 8  # object slots per group
GROUPED_LEAF = 16  # leaf size the grouped tree is collapsed to
REL_SLOTS = 16  # object groups one node group's leaves may take
MAX_GROUPS = 1 << 19


def n_groups(tabs: PacketTables) -> int:
    return tabs.objs.shape[0] // GROUP


def pack_grouped(scene: SceneData, tb: ThreadedBVH
                 ) -> Optional[PacketTables]:
    """K7's tables from a leaf-collapsed threaded tree, or None where the
    JAX package's pack_grouped refuses it (callers then take K8)."""
    box = np.asarray(tb.node_box, np.float32)
    meta = np.asarray(tb.node_meta, np.int64)
    oorder = np.asarray(tb.obj_order, np.int64)
    N = box.shape[0]
    skip, first, nobjs = meta[:, 0], meta[:, 1], meta[:, 2]
    leaf = nobjs > 0
    if N and nobjs.max(initial=0) > GROUP * (REL_SLOTS // 2):
        return None
    # a protected object (its hit can escape the leaf box) in a multi-group
    # leaf: the JAX kernel's per-column gate would differ from the per-lane
    # walk there, so it refuses the tree
    prot = protect_mask(scene)
    if N and prot.any():
        for li in np.nonzero(leaf & (nobjs > GROUP))[0]:
            if prot[oorder[first[li]:first[li] + nobjs[li]]].any():
                return None
    ng = np.where(leaf, np.maximum(1, -(-nobjs // GROUP)), 0)
    og_first = np.cumsum(ng) - ng  # leaves take groups in DFS order
    if N and np.add.reduceat(ng, np.arange(0, N, GROUP)).max() > REL_SLOTS:
        return None
    total = int(ng.sum())
    if total >= MAX_GROUPS:
        return None
    # object k of obj_order sits in leaf L (first[L] <= k < first[L] +
    # nobjs[L]), at slot og_first[L] * 8 + (k - first[L])
    ids = np.full(max(total, 1) * GROUP, -1, np.int64)
    O = oorder.shape[0]
    if O:
        leaves = np.nonzero(leaf)[0]
        by_first = leaves[np.argsort(first[leaves], kind="stable")]
        ks = np.arange(O, dtype=np.int64)
        L = by_first[np.searchsorted(first[by_first], ks, side="right") - 1]
        ids[og_first[L] * GROUP + (ks - first[L])] = oorder
    data, types, _ = packed_objects_np(scene)
    nodes = pack_nodes(box, skip, np.where(leaf, og_first * GROUP, 0),
                       ng * GROUP)
    return PacketTables("grouped", torch.from_numpy(nodes),
                        torch.from_numpy(pack_slots(data, types, ids)))


def from_jax_grouped(node_g, obj_g, og_base, n_nodes: int,
                     n_groups_: int) -> PacketTables:
    """K7's tables from the JAX package's GroupedBVH arrays (NumPy): the
    lane-column tables unpacked into node and slot records, relative leaf
    groups made absolute."""
    node_g = np.asarray(node_g, np.float32)
    obj_g = np.asarray(obj_g, np.float32)
    og_base = np.asarray(og_base, np.int64)
    i = np.arange(n_nodes)
    field = lambda f: node_g[f * GROUP + i % GROUP, i // GROUP]
    box = np.stack([field(f) for f in range(6)], axis=1)
    skip = field(6).astype(np.int64)
    meta = field(7).astype(np.int64)
    ng = meta % 16
    first = np.where(ng > 0, (og_base[i // GROUP] + meta // 16) * GROUP, 0)
    nodes = pack_nodes(box, skip, first, ng * GROUP)
    s = np.arange(max(n_groups_, 1) * GROUP)
    slot = lambda f: obj_g[f * GROUP + s % GROUP, s // GROUP]
    objs = np.zeros((s.shape[0], 16), np.float32)
    for f in range(12):
        objs[:, f] = slot(f)
    typ = slot(12).astype(np.int64)
    ints = objs.view(np.int32)
    ints[:, 12] = typ
    ints[:, 13] = np.where(typ >= 0, slot(13).astype(np.int64), -1)
    return PacketTables("grouped", torch.from_numpy(nodes),
                        torch.from_numpy(objs))

