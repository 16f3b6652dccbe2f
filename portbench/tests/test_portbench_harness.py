"""The harness finds every part by name, and its arithmetic."""

import importlib.util
import json
import math
import os
import time

import pytest

from portbench import harness, trace

with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


def test_configs_cells_and_metrics_are_found_by_name():
    for c in BENCH["configs"]:
        cfg = harness.load_json("configs", c["name"] + ".json")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert importlib.util.find_spec("portbench.scenes."
                                        + cfg["generator"])
    for w in BENCH["workloads"]:
        spec = harness.load_json("workloads", w["name"] + ".json")
        for k in ("config", "traffic", "chips", "why"):
            assert spec[k] == w[k], (w["name"], k)
        assert importlib.util.find_spec("portbench.traffic." + spec["kind"])
    readers = harness.readers()
    for m in BENCH["per_layer"]:
        assert m["name"] in readers, m["name"]
        assert readers[m["name"]].UNIT == m["unit"]
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names


def test_every_reader_reads_nothing_from_nothing():
    for name, mod in harness.readers().items():
        assert mod.read({}) is None, name
        assert mod.read({"unit": "frame", "spans": {}}) is None, name


def test_the_rate_is_the_window_over_the_units_done():
    times = iter([0.05, 0.01, 0.2, 0.01, 0.03] * 20)
    first = []

    def unit(i):
        first.append(time.perf_counter()) if i == 0 else None
        time.sleep(next(times))
    n, secs = harness.closed_loop(0.3, unit)
    wall = time.perf_counter() - first[0]
    assert secs >= 0.3 and n >= 3
    assert abs(secs - wall) < 0.01  # the whole window, stalls included


def test_p95_is_over_all_requests_not_chunks():
    xs = [1.0] * 90 + [100.0] * 10
    assert harness.p95(xs) == 100.0
    # a mean of per-chunk 95th percentiles would read 1.0 on 9 chunks
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([]) is None


def test_checks_fail_on_missing_or_nan_numbers():
    c = harness.Checks()
    c.add("a", 0.5, 1.0)
    assert c.correct
    c.add("b", math.nan, 1.0)
    assert not c.correct
    c2 = harness.Checks()
    c2.add("a", None, 1.0)
    assert not c2.correct
    assert not harness.Checks().correct


def test_seeds_past_32_bits_are_deterministic_and_keyed():
    big = 2**33 + 5
    assert harness.derive_seed(big, 1) == harness.derive_seed(big, 1)
    assert harness.derive_seed(big, 1) != harness.derive_seed(big, 2)
    assert 0 <= harness.derive_seed(big, 1) < 2**63


def test_torch_kernels_are_told_apart_by_name():
    assert trace.is_torch("void at::native::reduce_kernel<512, 1>(...)")
    assert trace.is_torch("Memcpy DtoH (Device -> Pageable)")
    assert not trace.is_torch("(anonymous namespace)::whitted_level_kernel(")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_its_metrics(name):
    """Each cell reports setup_s, another end-to-end metric and a
    per-layer metric, and every per-layer metric's end-to-end metric."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    mine = {n for n, m in e2e.items()
            if "workloads" not in m or name in m["workloads"]}
    assert "setup_s" in mine and len(mine) >= 2
    layer = [m for m in BENCH["per_layer"] if name in m["workloads"]]
    assert layer
    for m in layer:
        assert m["moves"] in mine, (name, m["name"])


def test_setup_leaves_out_the_references_seconds():
    ctx = harness.Context("rtow.frame", 1, 0, 0, device="cpu",
                          t_start=time.time() - 10.0)
    ctx.exclude(4.0)
    assert 5.9 < ctx.setup_s() < 6.5
    assert ctx.phases[-1][0] == "window start"


def test_idle_is_read_against_the_unprofiled_window():
    # 2 profiled frames, 0.3 s busy; the profiled stretch took 2 s, the
    # window 0.5 s a frame: the stretch's wall time is not used
    prof = {"units": 2, "busy_s": 0.3, "window_s": 2.0}
    obs = {"unit": "frame", "unit_s": 0.5, "profile": prof}
    assert abs(trace.idle_share(obs, "frame") - 0.7) < 1e-12
    assert trace.idle_share(obs, "step") is None
    assert trace.idle_share(dict(obs, unit_s=None), "frame") is None



def test_every_seed_visits_the_same_cameras_above_the_ground():
    from portbench import samples

    spec = harness.load_json("workloads", "rtow.view.json")["params"]
    offsets, every = spec["camera_offsets_deg"], spec["moves_every"]
    eye = [13.0, 2.0, 3.0]  # rtow_final's camera
    count = every * len(offsets)
    runs = [samples.cameras(s, eye, offsets, every, 3 * count)
            for s in (1, 2**33 + 5, 7 * 2**31)]
    for cams in runs:
        assert all(cams[k] == cams[k - k % every] for k in range(len(cams)))
        assert cams[count:2 * count] == cams[:count]  # the order repeats
        assert all(samples.viewer_eye(*c)[1] > 0.5 for c in cams)
    sets = [sorted(set(cams)) for cams in runs]
    assert sets[0] == sets[1] == sets[2] and len(sets[0]) == len(offsets)
    assert runs[0][:count] != runs[1][:count]  # in another order
