"""The program-traced stretch's arithmetic and its readers, on hand-made
spans, intervals and summaries."""

import pytest

from portbench import harness, program_trace as pt

MS = 1_000_000  # ns


def span(i, name, a, b, parent=None, thread=1, unit=0):
    return dict(id=i, name=name, parent=parent, unit=unit, thread=thread,
                start_ns=a * MS, end_ns=b * MS)


def ms(table):
    return {k: round(v * 1e3, 9) for k, v in table.items()}


def test_idle_is_the_window_less_the_device_activity():
    device = [(2 * MS, 4 * MS, "k"), (3 * MS, 5 * MS, "k"),
              (7 * MS, 8 * MS, "k")]
    assert pt.idle_intervals(device, 0, 10 * MS) == [
        (0, 2 * MS), (5 * MS, 7 * MS), (8 * MS, 10 * MS)]
    assert pt.idle_intervals(device, 3 * MS, 6 * MS) == [(5 * MS, 6 * MS)]
    assert pt.idle_intervals([], 0, MS) == [(0, MS)]


def test_nested_spans_give_idle_to_the_innermost():
    spans = [span(0, "frame", 0, 10), span(1, "level", 2, 6, parent=0),
             span(2, "intersect", 3, 4, parent=1)]
    own, inside = pt.attribute([(1 * MS, 5 * MS)], spans)
    assert ms(own) == {"frame": 1.0, "level": 2.0, "intersect": 1.0}
    assert ms(inside) == {"frame": 4.0, "level": 3.0, "intersect": 1.0}


def test_an_interval_across_two_spans_is_split_by_overlap():
    spans = [span(0, "a", 0, 3), span(1, "b", 3, 10, unit=1)]
    own, inside = pt.attribute([(2 * MS, 6 * MS)], spans)
    assert ms(own) == {"a": 1.0, "b": 3.0}
    assert ms(inside) == ms(own)


def test_time_no_span_covers_is_no_spans():
    spans = [span(0, "a", 2, 4)]
    own, inside = pt.attribute([(0, 3 * MS), (5 * MS, 6 * MS)], spans)
    assert ms(own) == {"a": 1.0, pt.NO_SPAN: 3.0}
    assert ms(inside) == ms(own)
    own, _ = pt.attribute([(0, MS)], [])
    assert ms(own) == {pt.NO_SPAN: 1.0}


def test_spans_of_two_threads_share_the_time_they_overlap():
    spans = [span(0, "a", 0, 4, thread=1),
             span(1, "b", 2, 6, thread=2, unit=1),
             span(2, "b.inner", 3, 6, parent=1, thread=2, unit=1)]
    own, inside = pt.attribute([(0, 6 * MS)], spans)
    assert ms(own) == {"a": 3.0, "b": 0.5, "b.inner": 2.5}
    assert ms(inside) == {"a": 3.0, "b": 3.0, "b.inner": 2.5}
    assert abs(sum(own.values()) - 0.006) < 1e-12  # no interval counted twice


def test_span_times_and_counters_are_a_unit():
    rec = {"spans": [span(0, "level", 0, 2), span(1, "level", 2, 6),
                     span(2, "png", 0, 1), span(3, "png", 1, 4),
                     span(4, "png", 4, 6)],
           "counts": [dict(unit=0, name="lanes", n=10),
                      dict(unit=1, name="lanes", n=6),
                      dict(unit=None, name="tables.builds.x", n=2)]}
    total, median = pt.span_times(rec, 2)
    assert total == {"level": 3.0, "png": 3.0}
    assert median == {"level": 3.0, "png": 2.0}
    assert pt.counters(rec, 2) == {"lanes": 8.0, "tables.builds.x": 1.0}


class Event:
    def __init__(self, name, start, corr, cuda, end=None):
        from torch.autograd import DeviceType

        self._n, self._s, self._c = name, start, corr
        self._e = start if end is None else end
        self._d = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def device_type(self):
        return self._d


def drifting(n=400, every=MS, drift_from=100, per_ms=2_000):
    """Launch calls each ``every`` ns, their kernels 4 us after them on
    the device's clock, which runs ahead by ``per_ms`` ns a ms from the
    ``drift_from``-th on, as profiles on an H100 did."""
    events = []
    for i in range(n):
        t = i * every
        lag = 4_000 + max(0, i - drift_from) * per_ms * every // MS
        events += [Event("cudaLaunchKernel", t, i, False),
                   Event("k", t + lag, i, True, end=t + lag + 1_000)]
    return events


def test_the_device_clock_is_moved_onto_the_hosts():
    events = drifting()
    calls = pt._calls(events)
    lags = pt._lags(events, calls)
    assert lags[0][1] == 4_000 and lags[-1][1] == 4_000 + 299 * 2_000
    moved = pt.host_aligned(events, pt.clock_shift(lags))
    after = [a - i * MS for i, (a, _, _) in enumerate(moved)]
    # within a window's drift of the host call, never far before it
    assert max(abs(x) for x in after) < pt.ALIGN_NS // MS * 2_000
    raw = [a - i * MS for i, (a, _, _, ) in enumerate(
        pt.trace._device(events))]
    assert max(raw) > 10 * max(abs(x) for x in after)
    assert pt.host_aligned([], pt.clock_shift([])) == []


def test_k3_kernels_meet_the_spans_that_launched_them():
    spans = [span(0, pt.CLOCK_SPAN, 0, 2), span(1, pt.CLOCK_SPAN, 5, 6)]
    events = [Event("cudaLaunchKernel", 1 * MS, 7, False),
              Event("cudaLaunchKernel", 5 * MS + 10, 8, False),
              Event("(anonymous)::whitted_level_kernel", 3 * MS, 7, True),
              Event("(anonymous)::whitted_level_kernel", 6 * MS, 8, True)]
    none = pt.clock_shift([])
    n, raw, moved, launch = pt.clock_check(events, spans, none)
    assert n == 2 and raw == moved == [3 * MS, MS]
    assert launch == [MS, 10]
    shift = pt.clock_shift(pt._lags(events, pt._calls(events)))
    assert pt.clock_check(events, spans, shift)[2] == [2 * MS + 10, 10]
    # no launch call to match: the kernels and spans in order
    n, raw, moved, launch = pt.clock_check(events[2:], spans, none)
    assert (n, raw, launch) == (2, [3 * MS, MS], [])
    assert pt.clock_check(events, [], none) is None


def obs_of(unit, **prog):
    base = dict(unit=unit, units=2, span_ms={}, span_median_ms={},
                counts={}, idle_s=0.0, idle={}, idle_in={})
    base.update(prog)
    return {"unit": unit, "program": base}


def metric(name):
    return harness.readers()[name].read


FRAME = obs_of(
    "frame", span_ms={"whitted.level": 310.5, "render.bins": 12.25},
    counts={"whitted.lanes": 400.0, "whitted.lanes_live": 100.0,
            "tables.builds.level_tables": 118.0,
            "tables.builds.packed_objects": 236.0, "sync.host_reads": 6.0},
    idle_s=2.0, idle_in={"whitted.level": 1.5, pt.NO_SPAN: 0.5})


@pytest.mark.parametrize("name, want", [
    ("tree.host_ms.frame", 310.5),
    ("tree.live_share.frame", 0.25),
    ("tables.builds.frame", 354.0),
    ("dispatch.host_reads.frame", 6.0),
    ("bins.host_ms.frame", 12.25),
    ("device.idle_in_tree.frame", 0.75),
])
def test_frame_metrics_read_the_summary(name, want):
    assert metric(name)(FRAME) == want
    assert metric(name)(dict(FRAME, program=None)) is None
    assert metric(name)(obs_of("request")) is None


def test_frame_counts_that_are_absent_read_zero_or_nothing():
    bare = obs_of("frame", counts={"whitted.lanes": 4.0})
    assert metric("dispatch.host_reads.frame")(bare) == 0.0
    assert metric("tables.builds.frame")(bare) == 0
    assert metric("bins.host_ms.frame")(bare) is None  # no bins on the path
    assert metric("device.idle_in_tree.frame")(bare) is None  # no idle


def test_viewer_png_reads_the_median_span():
    obs = obs_of("request", span_median_ms={"viewer.png": 26.5})
    assert metric("viewer.png_ms")(obs) == 26.5
    assert metric("viewer.png_ms")(FRAME) is None


def test_a_program_without_the_recorder_gives_no_stretch(monkeypatch):
    monkeypatch.setattr(pt, "recorder", lambda: None)
    assert pt.stretch(lambda i: None, 2, "frame") is None
