"""The port's accel tables vs the JAX package's, array for array.

The grid build, the SAH BVH build, its threading and leaf collapse, the
packet tables of K7 (``pack_grouped``) and K8 (``pack_threaded``), the grid
emulation's tables (``pack_grid``) and the primary bins of K9 are built by
both packages from the same scene and compared exactly, with the port's
native builder (``native.py``) and with its NumPy builder.  The JAX package
builds with its own defaults.
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributionraytracer_tpu.accel import bvh as jbvh
from distributionraytracer_tpu.accel import grid as jgrid
from distributionraytracer_tpu.accel import pallas_binned as jbin
from distributionraytracer_tpu.accel import pallas_bvh as jpb
from distributionraytracer_tpu.accel import pallas_grid as jpg
from distributionraytracer_tpu.accel import pallas_packet as jpp
from distributionraytracer_tpu.scene.builder import (
    SceneBuilder as JaxSceneBuilder,
)
from distributionraytracer_tpu_torch import native
from distributionraytracer_tpu_torch.accel import bvh as tbvh
from distributionraytracer_tpu_torch.accel import cuda_binned as tbin
from distributionraytracer_tpu_torch.accel import cuda_bvh as tpb
from distributionraytracer_tpu_torch.accel import cuda_grid as tpg
from distributionraytracer_tpu_torch.accel import cuda_packet as tpp
from distributionraytracer_tpu_torch.accel import grid as tgrid
from distributionraytracer_tpu_torch.scene.types import ACCEL_BVH, ACCEL_GRID

from torch_port_util import prim_scene, to_port
from torch_scenes import crowd_scene, mesh_scene

torch.set_num_threads(1)

BUILDERS = ["native", "numpy"]


def _with_accel(scene, accel):
    return dataclasses.replace(scene, static=dataclasses.replace(
        scene.static, accel=accel))


SCENES = {
    # a scanned-mesh stand-in with its spheres; 1,100 spheres on a plane;
    # every primitive type with two planes
    "mesh": lambda: mesh_scene(JaxSceneBuilder, n_tri=2000, accel=ACCEL_BVH,
                               res=(32, 32)),
    "crowd": lambda: _with_accel(crowd_scene(JaxSceneBuilder), ACCEL_BVH),
    "prim": lambda: _with_accel(prim_scene(), ACCEL_BVH),
}
_CACHE = {}


def _scene(name):
    if name not in _CACHE:
        js = SCENES[name]()
        _CACHE[name] = (js, to_port(js))
    return _CACHE[name]


def _fields_equal(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _bits(t):
    """A packed f32 table as its int32 bits (int fields may be NaNs)."""
    return t.view(torch.int32).numpy()


def test_native_builder_available():
    """The port compiles ``native/drt_native.cpp`` into its own build
    directory; the tracked library stays as it is."""
    assert native.available() and native.builder() == "native"
    assert native._compile().startswith(native.BUILD_DIR)


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_bvh_build_thread_collapse_match_jax(name, builder):
    js, ps = _scene(name)
    ours = tbvh.build_bvh(ps, use_native=builder == "native")
    ref = jbvh.build_bvh(js)
    _fields_equal(ref, ours)
    tj, tp = jbvh.thread_bvh(ref), tbvh.thread_bvh(ours)
    _fields_equal(tj, tp)
    for mb in (False, True):
        pj, pp = jbvh.protect_mask(js, mb), tbvh.protect_mask(ps, mb)
        assert np.array_equal(pj, pp)
        for leaf in (tpp.GROUPED_LEAF, tpb.PACKET_LEAF, 4):
            _fields_equal(jbvh.collapse_leaves(tj, leaf, protect=pj),
                          tbvh.collapse_leaves(tp, leaf, protect=pp))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_packet_tables_match_jax(name):
    """K7's and K8's tables from the port's tree equal those converted from
    the JAX package's tables; the grouped packers refuse the same trees."""
    js, ps = _scene(name)
    tj = jbvh.thread_bvh(jbvh.build_bvh(js))
    tp = tbvh.thread_bvh(tbvh.build_bvh(ps))
    prot = tbvh.protect_mask(ps)
    cj = jbvh.collapse_leaves(tj, tpp.GROUPED_LEAF, protect=prot)
    gj = jpp.pack_grouped(js, cj)
    gp = tpp.pack_grouped(ps, tbvh.collapse_leaves(tp, tpp.GROUPED_LEAF,
                                                   protect=prot))
    assert (gj is None) == (gp is None)
    if gp is not None:
        conv = tpp.from_jax_grouped(gj.node_g, gj.obj_g, gj.og_base,
                                    gj.n_nodes, gj.n_groups)
        assert tpp.n_groups(gp) == gj.n_groups
        assert np.array_equal(_bits(conv.nodes), _bits(gp.nodes))
        assert np.array_equal(_bits(conv.objs), _bits(gp.objs))
        # every object sits in exactly one slot; groups never straddle
        ids = _bits(gp.objs)[:, 13]
        assert np.array_equal(np.sort(ids[ids >= 0]),
                              np.arange(ps.static.n_objects))
    for mb in (False, True):
        prot = tbvh.protect_mask(ps, mb)
        cj = jbvh.collapse_leaves(tj, tpb.PACKET_LEAF, protect=prot)
        lj = jpb.pack_threaded(js, cj)
        lp = tpb.pack_threaded(ps, tbvh.collapse_leaves(
            tp, tpb.PACKET_LEAF, protect=prot))
        assert lj is not None
        conv = tpb.from_jax_threaded(ps, cj.node_box, cj.node_meta,
                                     cj.obj_order)
        assert np.array_equal(_bits(conv.nodes), _bits(lp.nodes))
        assert np.array_equal(_bits(conv.objs), _bits(lp.objs))
        # the JAX node table decoded: boxes, skips, leaf ranges, object ids
        N = lp.n_nodes
        nt, ot = np.asarray(lj.node_tab), np.asarray(lj.obj_tab)
        bmin, bmax, skip, first, count = (x.numpy() for x in
                                          tbvh.node_fields(lp.nodes))
        assert np.array_equal(nt[0:3, :N].T, bmin)
        assert np.array_equal(nt[3:6, :N].T, bmax)
        assert np.array_equal(nt[6, :N].astype(np.int64), skip)
        meta, leaf = nt[7, :N].astype(np.int64), count > 0
        assert np.array_equal(meta % jpb.MAX_LEAF, count)
        assert np.array_equal((meta // jpb.MAX_LEAF)[leaf], first[leaf])
        O = ps.static.n_objects
        assert np.array_equal(ot[13, :O].astype(np.int32),
                              _bits(lp.objs)[:, 13])


def test_node_records_encode_large_trees():
    """The packet node records take every tree whose numbers fit in int32:
    first slots past 2^22 (the grouped packer's 2^19 groups of 8) and
    leaves of thousands of objects (a fallback leaf) decode exactly; a tree
    whose leaves do not skip to the next node is refused."""
    L = (tpp.MAX_GROUPS // 2) - 1  # leaves of two groups each
    N = L + 2
    skip = np.arange(1, N + 1, dtype=np.int64)
    skip[0] = N  # the root's subtree is the whole tree
    count = np.full(N, 2 * tpp.GROUP, np.int64)
    count[0] = 0
    count[-1] = 5000
    first = np.zeros(N, np.int64)
    first[1:] = np.cumsum(count[:-1])
    rng = np.random.default_rng(0)
    box = rng.standard_normal((N, 6)).astype(np.float32)
    nodes = torch.from_numpy(tbvh.pack_nodes(box, skip, first, count))
    bmin, bmax, sk, fs, ct = (x.numpy() for x in tbvh.node_fields(nodes))
    assert first[-2] > 1 << 21 and first[-1] + count[-1] > 1 << 22
    assert np.array_equal(bmin, box[:, 0:3])
    assert np.array_equal(bmax, box[:, 3:6])
    assert np.array_equal(sk, skip)
    assert np.array_equal(fs, np.where(count > 0, first, 0))
    assert np.array_equal(ct, count)
    skip[1] = 3
    with pytest.raises(ValueError, match="DFS pre-order"):
        tbvh.pack_nodes(box, skip, first, count)


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("name", ["mesh", "prim"])
def test_grid_build_and_emulation_tables_match_jax(name, builder):
    js, ps = _scene(name)
    js, ps = _with_accel(js, ACCEL_GRID), _with_accel(ps, ACCEL_GRID)
    use_native = builder == "native"
    assert np.array_equal(jgrid.object_bboxes(js), tgrid.object_bboxes(ps))
    gj = jgrid.build_grid(js)
    gp = tgrid.build_grid(ps, use_native=use_native)
    _fields_equal(gj, gp)
    occ = (np.diff(gp.cell_start) > 0).astype(np.uint8)
    n = [int(k) for k in gp.ncells]
    assert np.array_equal(jgrid._chebyshev_dist(occ, *n),
                          tgrid._chebyshev_dist(occ, *n,
                                                use_native=use_native))
    for mb in (False, True):
        assert np.array_equal(jpg.emulation_bboxes(js, gj, mb),
                              tpg.emulation_bboxes(ps, gp, mb))
        for kernel in ("grouped", "legacy"):
            pj = jpg.pack_grid(js, gj, mb, packet_kernel=kernel)
            pp = tpg.pack_grid(ps, gp, mb, packet_kernel=kernel,
                               use_native=use_native)
            assert pj is not None
            for f in ("bbox_min", "bbox_max", "ncells"):
                assert np.array_equal(np.asarray(getattr(pj, f)),
                                      getattr(pp, f))
            if isinstance(pj.tabs, jpp.GroupedBVH):
                t = pj.tabs
                conv = tpp.from_jax_grouped(t.node_g, t.obj_g, t.og_base,
                                            t.n_nodes, t.n_groups)
                assert pp.tabs.kind == "grouped"
                assert np.array_equal(_bits(conv.nodes),
                                      _bits(pp.tabs.nodes))
                assert np.array_equal(_bits(conv.objs), _bits(pp.tabs.objs))
            else:
                assert pp.tabs.kind == "threaded"
                nt = np.asarray(pj.tabs.node_tab)
                N = pp.tabs.n_nodes
                assert np.array_equal(nt[0:3, :N].T, pp.tabs.nodes[:, 0:3])


@pytest.mark.parametrize("res", [(32, 32), (64, 32)])
def test_primary_bins_match_jax(res):
    """The group boxes and the chains' candidate CSR equal the JAX
    package's; the port pads its arrays to a bucket."""
    js = mesh_scene(JaxSceneBuilder, n_tri=2000, accel=ACCEL_BVH, res=res)
    ps = to_port(js)
    tp = tbvh.thread_bvh(tbvh.build_bvh(ps))
    gp = tpp.pack_grouped(ps, tbvh.collapse_leaves(tp, tpp.GROUPED_LEAF))
    gj = jpp.pack_grouped(js, jbvh.collapse_leaves(
        jbvh.thread_bvh(jbvh.build_bvh(js)), jpp.GROUPED_LEAF))
    boxes = tbin.group_boxes(ps, gp)
    ref = jbin.group_boxes(js, gj)  # padded to whole 128-group columns
    G = boxes.shape[0]
    assert G == gj.n_groups and (ref[G:, 6] == 0).all()
    assert np.array_equal(ref[:G], boxes)
    W, H = res
    bj = jbin.build_primary_bins(js, jbin.group_boxes(js, gj), gj, H, W, 1)
    bp = tbin.build_primary_bins(ps, boxes, H, W, 1)
    cs = np.asarray(bj.chain_start)
    n = int(cs[-1])
    assert n > 0 and bp.n_chains == H * W // tbin.LANES
    assert np.array_equal(cs, bp.chain_start.numpy())
    assert np.array_equal(np.asarray(bj.cand)[:n], bp.cand.numpy()[:n])
    assert np.array_equal(np.asarray(bj.cand_dist)[:n],
                          bp.cand_dist.numpy()[:n])
    P = bp.cand.shape[0]
    assert P % tbin.P_BUCKET == 0 and P >= n
    assert (bp.cand_dist.numpy()[n:] == np.float32(3.4028235e38)).all()
    conv = tbin.from_jax_primary_bins(bj.chain_start, bj.cand, bj.cand_dist)
    for a, b in zip(conv, bp):
        assert torch.equal(a, b)


def test_primary_bins_candidate_cap(monkeypatch):
    """Past MAX_CANDIDATES (chain, group) pairs the frame is not binned
    (it takes the packet route) instead of growing without bound."""
    js = mesh_scene(JaxSceneBuilder, n_tri=2000, accel=ACCEL_BVH,
                    res=(32, 32))
    ps = to_port(js)
    tp = tbvh.thread_bvh(tbvh.build_bvh(ps))
    gp = tpp.pack_grouped(ps, tbvh.collapse_leaves(tp, tpp.GROUPED_LEAF))
    boxes = tbin.group_boxes(ps, gp)
    full = tbin.build_primary_bins(ps, boxes, 32, 32, 1)
    n = int(full.chain_start[-1])
    monkeypatch.setattr(tbin, "MAX_CANDIDATES", n - 1)
    assert tbin.build_primary_bins(ps, boxes, 32, 32, 1) is None
    monkeypatch.setattr(tbin, "MAX_CANDIDATES", n)
    assert tbin.build_primary_bins(ps, boxes, 32, 32, 1) is not None


def test_native_float_parsing_matches_float():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(500) * 10.0 ** rng.integers(-8, 8, 500)
    text = ("  v " + "\n".join(repr(float(v)) if i % 3 else f"{v:.6e}"
                               for i, v in enumerate(vals)) + " tail")
    b = text.encode()
    got, pos = native.parse_floats_native(b, 4, len(vals))
    ref = np.array([float(t) for t in text.split()[1:-1]])
    assert np.array_equal(got, ref)
    assert b[pos:].strip() == b"tail"
    with pytest.raises(ValueError, match="expected"):
        native.parse_floats_native(b, 4, len(vals) + 1)
