"""K9's work on the CPU: the plain stream's per-chain counts
(``binned_closest_plain``'s ``chain_groups`` and ``chain_tests``) against a
direct count, K9's work list (``closest_work_plain``,
``closest_units_plain``) against the chains' lists, and its segmented
stream (``binned_closest_segments_plain``) against ``binned_closest_plain``.

The kernel computes the same work list on the card (its first pass;
``test_torch_cuda.py`` holds it to ``closest_work_plain`` there, and the
kernel to ``binned_closest_plain`` on every lane).  The scene is the mesh
at 64x64 pixels (32 chains), on the BVH and the grid route.
"""

import pytest
import torch

from distributionraytracer_tpu_torch.accel import cuda_binned as CBN
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    _block_perm, _rays_from_samples, make_samples,
)
from distributionraytracer_tpu_torch.ops.common import FLT_MAX
from distributionraytracer_tpu_torch.ops.intersect import hit_packed
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene import SceneBuilder
from distributionraytracer_tpu_torch.scene.types import ACCEL_BVH, ACCEL_GRID

from torch_scenes import mesh_scene

torch.set_num_threads(1)

RES = (64, 64)
CASES = ("primary", "sparse", "dead-chains", "long-chain")


@pytest.fixture(scope="module", params=[ACCEL_BVH, ACCEL_GRID],
                ids=["bvh", "grid"])
def frame(request):
    """The renderer's grouped tables, its primary bins and the
    block-permuted primary rays of one SampleSet."""
    scene = mesh_scene(SceneBuilder, n_tri=2000, accel=request.param,
                       res=RES)
    r = Renderer(scene, RenderConfig(spp=0), device="cpu")
    W, H = RES
    bins = r._bins_for(H, W, 1)
    samples = make_samples(r.scene, r.cfg, torch.Generator().manual_seed(4))
    o, d, t, _ = _rays_from_samples(r.scene, r.cfg, samples)
    perm = torch.as_tensor(_block_perm(H, W, 1)).long()
    tabs = r.tabs if request.param == ACCEL_BVH else r.tabs.tabs
    return tabs, bins.primary, o[perm], d[perm], t[perm]


def _batch(pb, o, d, t, case):
    """(o, d, time, valid or None) of one case."""
    n = o.shape[0]
    if case == "sparse":
        return o, d, t, torch.rand(n, generator=torch.Generator()
                                   .manual_seed(5)) < 0.3
    if case == "dead-chains":  # every third chain without a valid lane
        v = torch.ones((n // CBN.LANES, CBN.LANES), dtype=torch.bool)
        v[::3] = False
        return o, d, t, v.reshape(-1)
    if case == "long-chain":  # the longest list's lanes look straight up
        cs = pb.chain_start.long()
        c = int(torch.argmax(cs[1:] - cs[:-1]))
        d = d.clone()
        d[c * CBN.LANES:(c + 1) * CBN.LANES] = torch.tensor([0.0, 1.0, 0.0])
        return o, d, t, None
    return o, d, t, None


def _direct_counts(tabs, pb, o, d, t, valid):
    """Per chain, a serial walk of its list: before each group, stop once
    every valid lane's best t is below the group's cand_dist; else test
    each valid lane against each live slot.  Returns the groups streamed
    and the slot tests of each chain."""
    R = o.shape[0]
    v = torch.ones((R,), dtype=torch.bool) if valid is None else valid
    ints = tabs.objs.view(torch.int32)
    cs = pb.chain_start.tolist()
    groups, tests = [], []
    for c in range(pb.n_chains):
        lanes = slice(c * CBN.LANES, min((c + 1) * CBN.LANES, R))
        oc, dc, tc, vc = o[lanes], d[lanes], t[lanes], v[lanes]
        n = oc.shape[0]
        bt = torch.full((n,), FLT_MAX)
        g = k_tests = 0
        rep = lambda x: x.repeat_interleave(CBN.GROUP, 0)
        for k in range(cs[c], cs[c + 1]):
            if bool((~vc | (bt < pb.cand_dist[k])).all()):
                break
            g += 1
            slots = int(pb.cand[k]) * CBN.GROUP + torch.arange(CBN.GROUP)
            typ = ints[slots, 12]
            tk, _ = hit_packed(rep(oc), rep(dc), rep(tc),
                               tabs.objs[slots].repeat(n, 1), typ.repeat(n),
                               False)
            tk = tk.reshape(n, CBN.GROUP).amin(1)
            bt = torch.where(vc & (tk < bt), tk, bt)
            k_tests += int(vc.sum()) * int((typ >= 0).sum())
        groups.append(g)
        tests.append(k_tests)
    return torch.tensor(groups), torch.tensor(tests)


@pytest.mark.parametrize("case", CASES)
def test_chain_stats_match_a_direct_count(frame, case):
    """binned_closest_plain's per-chain groups streamed and slot tests
    equal a serial walk of each chain's list, and sum to its totals."""
    tabs, pb, o, d, t = frame
    o, d, t, valid = _batch(pb, o, d, t, case)
    stats = {}
    CBN.binned_closest_plain(tabs, pb, o, d, t, valid, stats=stats)
    groups, tests = _direct_counts(tabs, pb, o, d, t, valid)
    assert torch.equal(stats["chain_groups"], groups)
    assert torch.equal(stats["chain_tests"], tests)
    assert int(groups.sum()) == stats["groups"]
    assert int(tests.sum()) == stats["obj_tests"]
    cs = pb.chain_start.long()
    listed = cs[1:] - cs[:-1]
    assert bool((groups <= listed).all())
    if case == "long-chain":  # no hit: the chain streams its whole list
        c = int(torch.argmax(listed))
        assert int(groups[c]) == int(listed[c]) > 2 * CBN.SEGMENT_GROUPS
    if case == "dead-chains":
        assert not bool(groups[::3].any())


@pytest.mark.parametrize("segment_groups", [CBN.SEGMENT_GROUPS, 3])
@pytest.mark.parametrize("case", CASES)
def test_segmented_stream_equals_plain(frame, case, segment_groups):
    """The segmented stream (each quarter of a chain on each segment of
    its list, stopping against the best so far, the winners merged by
    (t, position)) gives binned_closest_plain's t, normal and object id
    on every lane."""
    tabs, pb, o, d, t = frame
    o, d, t, valid = _batch(pb, o, d, t, case)
    ref = CBN.binned_closest_plain(tabs, pb, o, d, t, valid)
    got = CBN.binned_closest_segments_plain(tabs, pb, o, d, t, valid,
                                            segment_groups=segment_groups)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    v = torch.ones_like(ref[2], dtype=torch.bool) if valid is None else valid
    assert 0.2 < float((ref[2] >= 0)[v].float().mean())


@pytest.mark.parametrize("segment_groups", [CBN.SEGMENT_GROUPS, 3, 1])
def test_work_list_covers_each_list(frame, segment_groups):
    """K9's units: every chain's first segment first, in chain order, then
    the tail items; each (chain, quarter) takes its list's positions in
    segments of at most segment_groups, in order, each position once."""
    _, pb, _, _, _ = frame
    work = CBN.closest_work_plain(pb, segment_groups)
    chain, quarter, first, end = CBN.closest_units_plain(pb, work,
                                                         segment_groups)
    C, Q = pb.n_chains, CBN.LANES // 32
    cs = pb.chain_start.long()
    listed = cs[1:] - cs[:-1]
    segs = torch.clamp(-(-listed // segment_groups), min=1)
    assert int(work.item_start[-1]) == int((segs - 1).sum())
    assert chain.numel() == Q * int(segs.sum())
    head = torch.arange(C * Q)
    assert torch.equal(chain[:C * Q], head // Q)
    assert torch.equal(quarter, torch.arange(chain.numel()) % Q)
    assert bool((end - first <= segment_groups).all())
    for c in range(C):
        for q in range(Q):
            u = torch.nonzero((chain == c) & (quarter == q))[:, 0]
            f, e = first[u], end[u]
            assert int(f[0]) == int(cs[c]) and int(e[-1]) == int(cs[c + 1])
            assert torch.equal(f[1:], e[:-1])
