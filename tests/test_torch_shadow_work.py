"""K10's work list on the CPU: the chains' streams, their split into work
items and the entries each item streams (``shadow_work_plain``,
``shadow_item_entries``), held against ``_chain_spans``, the tested set of
``binned_shadow_plain``.

The kernel computes the same work list on the card (its first two passes;
``test_torch_cuda.py`` holds them to these plain versions there).  The
scene is the box-ground mesh at 16x16 pixels with bins of ``SMALL_K``
tiles per axis, as in ``test_torch_light_bins``.
"""

import numpy as np
import pytest
import torch

from distributionraytracer_tpu_torch.accel import cuda_binned as CBN
from distributionraytracer_tpu_torch.config import RenderConfig
from distributionraytracer_tpu_torch.integrator.render import (
    make_samples, render_from_samples,
)
from distributionraytracer_tpu_torch.integrator.whitted import Intersectors
from distributionraytracer_tpu_torch.renderer import Renderer
from distributionraytracer_tpu_torch.scene import SceneBuilder
from distributionraytracer_tpu_torch.scene.types import ACCEL_BVH

from torch_scenes import first_entry_batch, mesh_scene, scattered_shadow_batch

torch.set_num_threads(1)

SMALL_K = 16
CASES = ("primary", "ragged", "dead-chains", "scattered", "first-entry")


@pytest.fixture(scope="module")
def frame():
    """The renderer (plain versions on the CPU), its light bins of SMALL_K
    tiles and the inputs of its primary shadow query."""
    scene = mesh_scene(SceneBuilder, n_tri=2000, accel=ACCEL_BVH,
                       res=(16, 16), ground="box")
    r = Renderer(scene, RenderConfig(spp=0, accel_cost_threshold=0),
                 device="cpu")
    lb = r._light_bins = CBN.build_light_bins(r.scene, r._gbox, SMALL_K)
    samples = make_samples(r.scene, r.cfg, torch.Generator().manual_seed(3))
    plan = r._plan(samples)
    assert plan.bins.lights is lb
    inter = plan.inter
    log = []

    def shadow(o, d, dist, exclude_obj, valid=None):
        if not log:
            log.append((o, d, dist, valid))
        return inter.shadow(o, d, dist, exclude_obj, valid=valid)

    render_from_samples(r.scene, r.cfg, samples, plan=plan._replace(
        inter=Intersectors(inter.closest, shadow)))
    return r, lb, log[0]


def _batch(frame, case):
    """(o, valid, light ids) of one case."""
    r, lb, (o, d, dist, valid) = frame
    n = o.shape[0]
    lid = CBN.shadow_light_ids(n, lb.n_lights, "cpu")
    if case == "ragged":  # R not a multiple of 128
        return o[:n - 51], valid[:n - 51], lid[:n - 51]
    if case == "dead-chains":  # every other chain without a live lane
        v = valid.clone().reshape(-1, CBN.LANES)
        v[::2] = False
        return o, v.reshape(-1), lid
    if case == "scattered":
        so, _, _, sv, sl = scattered_shadow_batch(
            r.scene.light_pos.numpy(), 4 * CBN.LANES, seed=1)
        return (torch.from_numpy(so), torch.from_numpy(sv),
                torch.from_numpy(sl))
    if case == "first-entry":
        fo, _, _, fv, fl = first_entry_batch(r.tabs, lb, r.scene.light_pos,
                                             12)
        return fo, fv, fl
    return o, valid, lid


@pytest.mark.parametrize("item_entries", [CBN.ITEM_ENTRIES, 4])
@pytest.mark.parametrize("case", CASES)
def test_work_items_cover_the_chain_spans(frame, case, item_entries):
    """Each chain's stream, split into items of at most ``item_entries``
    positions, gives exactly the entries of ``_chain_spans``: in each
    chain's order, every entry once, no item past ``item_entries``; chains
    without a live lane stream nothing."""
    _, lb, _ = frame
    o, valid, lid = _batch(frame, case)
    n = -(-o.shape[0] // CBN.LANES) * CBN.LANES
    C = n // CBN.LANES
    work = CBN.shadow_work_plain(lb, lid, o, valid, item_entries)
    it, pos = CBN.shadow_item_entries(lb, work, item_entries)
    O = CBN._pad_lanes(o, n).reshape(C, CBN.LANES, 3)
    V = CBN._pad_lanes(valid, n).reshape(C, CBN.LANES)
    ech, ref = CBN._chain_spans(lb, CBN._pad_lanes(lid, n).reshape(C, -1),
                                O, V)
    items = work.chains[:, 7].long()
    chain_of = torch.repeat_interleave(torch.arange(C), items)
    assert torch.equal(chain_of[it], ech) and torch.equal(pos, ref)
    assert int(torch.bincount(it).max()) <= item_entries
    positions = work.chains[:, 6].long()
    assert torch.equal(items, -(-positions // item_entries))
    assert torch.equal(work.item_start[1:].long(), torch.cumsum(items, 0))
    entries = torch.bincount(ech, minlength=C)
    assert bool((positions >= entries).all())
    dead = ~V.any(1)
    assert bool((positions[dead] == 0).all())
    if case == "dead-chains":
        assert int(dead.sum()) >= C // 2
    if case == "scattered":  # some chain spans many items
        assert int(entries.max()) > 4 * CBN.ITEM_ENTRIES
    if case == "ragged":
        assert o.shape[0] % CBN.LANES


def test_first_entry_batch_is_occluded_by_its_first_entry(frame):
    """first_entry_batch's lanes are all occluded, each chain by the first
    entry it streams (the kernel's all-occluded exit)."""
    r, lb, _ = frame
    o, d, dist, valid, lid = first_entry_batch(r.tabs, lb, r.scene.light_pos,
                                               12)
    stats = {}
    occ = CBN.binned_shadow_plain(r.tabs, lb, lid, o, d, dist, valid,
                                  "bvh", stats=stats)
    assert bool(occ.all())
    assert torch.equal(stats["chain_entries"],
                       torch.ones(12, dtype=torch.long))
    assert np.unique(lid.numpy()).size == lb.n_lights
