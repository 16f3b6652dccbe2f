"""A program-traced stretch: the port's own spans and counters
(``distributionraytracer_tpu_torch.utils.spans``) over a few units of a
cell's work, laid over the device's idle time.

:func:`stretch` runs ``count`` units three times, after the cell's other
traced stretches:

1. with the program's recorder off, timed on the host clock ending in a
   synchronise;
2. with it on, timed the same way: the spans' host milliseconds and the
   counters are read from this run, and the two times give the
   recorder's cost;
3. with it on under ``torch.profiler`` (device activity and the host's
   CUDA calls alone, as ``trace.profile`` records them): each interval in
   which the device is idle is split among the innermost spans open over
   it, in proportion to the overlap, and time no span covers goes to
   "(no span)".  The recorder's stamps are on the profiler's host clock
   (Unix-epoch nanoseconds); the profiler's device stamps are moved onto
   that clock first (:func:`host_aligned`).

It returns the summary the per-layer readers take from ``obs["program"]``,
and prints the recorder's cost, the ten largest idle totals by span and
every counter a unit on standard error.  A program without the recorder
gives None, and every reader of ``obs["program"]`` then reads nothing.
"""

from __future__ import annotations

import bisect
import importlib
import statistics
import sys
import time

import numpy as np
import torch

from portbench import trace

NO_SPAN = "(no span)"
# K3's kernel, matched to the ``whitted.intersect`` span that launched it
CLOCK_KERNEL, CLOCK_SPAN = "whitted_level_kernel", "whitted.intersect"
# device time over which host_aligned takes one clock offset
ALIGN_NS = 20_000_000


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        return importlib.import_module(
            "distributionraytracer_tpu_torch.utils.spans")
    except ImportError:
        return None


def _timed(run_units):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_units()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def stretch(run_unit, count, unit):
    """Run ``run_unit(i)``, i = 0 .. 3 * count - 1, as the module says;
    ``unit`` names a unit ("frame", "request", "step").  Returns the
    summary dict, or None without the program's recorder."""
    rec = recorder()
    if rec is None:
        return None

    def units(first):
        return lambda: [run_unit(first + i) for i in range(count)]

    off_s = _timed(units(0))
    rec.collect()
    rec.enable()
    try:
        on_s = _timed(units(count))
        timed = rec.collect()
        window = []

        def profiled():
            window.append(time.time_ns())
            units(2 * count)()
            torch.cuda.synchronize()
            window.append(time.time_ns())

        _, events = trace._events(profiled, cpu=False)
        traced = rec.collect()
    finally:
        rec.disable()
        rec.collect()
    out = summary(timed, traced, events, window, count, unit)
    out.update(on_s=on_s / count, off_s=off_s / count)
    for line in lines(out):
        print(line, file=sys.stderr)
    return out


def span_times(records, count):
    """({name: host ms a unit inside the span}, {name: median ms of one})."""
    per = {}
    for s in records["spans"]:
        per.setdefault(s["name"], []).append((s["end_ns"] - s["start_ns"])
                                             / 1e6)
    return ({k: sum(v) / count for k, v in per.items()},
            {k: statistics.median(v) for k, v in per.items()})


def counters(records, count):
    """{counter: total a unit}, counts made outside any unit included."""
    out = {}
    for c in records["counts"]:
        out[c["name"]] = out.get(c["name"], 0) + c["n"]
    return {k: v / count for k, v in out.items()}


def _calls(events):
    """{CUDA correlation id: start of the host call that put the work on
    the device}."""
    from torch.autograd import DeviceType

    return {e.correlation_id(): e.start_ns() for e in events
            if e.device_type() != DeviceType.CUDA
            and any(k in e.name() for k in trace.LAUNCH_CALLS)}


def _lags(events, calls):
    """[(device activity start, start minus its host call's start)] of the
    activities whose call the profile holds, in device order."""
    from torch.autograd import DeviceType

    return sorted((e.start_ns(), e.start_ns() - calls[e.correlation_id()])
                  for e in events if e.device_type() == DeviceType.CUDA
                  and e.correlation_id() in calls)


def clock_shift(lags):
    """The device clock's offset from the host's along the profile, as a
    function of device time: in each ALIGN_NS of device time, the least
    lag of an activity behind its host call (an activity launched on an
    idle device starts within microseconds of its call), interpolated
    between the windows' centres.  On an H100 (torch 2.11, CUDA 12.8) the
    profiler's device stamps ran off its host stamps by 1.8-2.9 us a ms
    after the first few hundred ms of a profile, either way, while the
    device sat idle most of the time: the least lag read 3-5 us, then
    grew or fell by as much."""
    if not lags:
        return lambda t: np.zeros(np.shape(t))
    t0 = lags[0][0]
    least = {}
    for t, lag in lags:
        k = (t - t0) // ALIGN_NS
        least[k] = min(least.get(k, lag), lag)
    ks = sorted(least)
    xs = [t0 + k * ALIGN_NS + ALIGN_NS // 2 for k in ks]
    ys = [least[k] for k in ks]
    return lambda t: np.interp(t, xs, ys)


def host_aligned(events, shift):
    """The device activities, sorted (start, end, name), moved onto the
    host's clock by ``shift`` (:func:`clock_shift`)."""
    device = trace._device(events)
    if not device:
        return device
    sh = shift(np.array([a for a, _, _ in device], dtype=np.float64))
    return sorted((a - int(d), b - int(d), name)
                  for (a, b, name), d in zip(device, sh))


def idle_intervals(device, w0, w1):
    """The [a, b) intervals of [w0, w1) in which no device activity of
    ``device`` (sorted (start, end, name)) runs."""
    out, at = [], w0
    for a, b, _ in device:
        if a > at:
            out.append((at, min(a, w1)))
        at = max(at, b)
        if at >= w1:
            break
    if at < w1:
        out.append((at, w1))
    return [(a, b) for a, b in out if b > a]


def attribute(idle, spans):
    """Split each idle interval among the innermost spans that cover it
    (one a thread, equal shares where threads overlap), in proportion to
    the overlap.  Returns ({name: seconds} by innermost span, {name:
    seconds} by every span over it, its ancestors included); time no span
    covers is NO_SPAN's in both."""
    by_id = {s["id"]: s for s in spans}
    depth = {}

    def depth_of(s):
        if s["id"] not in depth:
            p = by_id.get(s["parent"])
            depth[s["id"]] = 0 if p is None else depth_of(p) + 1
        return depth[s["id"]]

    def chain(s):
        names = []
        while s is not None:
            if s["name"] not in names:
                names.append(s["name"])
            s = by_id.get(s["parent"])
        return names

    marks = sorted({t for s in spans for t in (s["start_ns"], s["end_ns"])})
    starts = sorted(spans, key=lambda s: s["start_ns"])
    ends = sorted(spans, key=lambda s: s["end_ns"])
    segments, open_, i, j = [], {}, 0, 0
    for a, b in zip(marks, marks[1:]):
        while i < len(starts) and starts[i]["start_ns"] <= a:
            open_.setdefault(starts[i]["thread"], {})[starts[i]["id"]] = \
                starts[i]
            i += 1
        while j < len(ends) and ends[j]["end_ns"] <= a:
            open_.get(ends[j]["thread"], {}).pop(ends[j]["id"], None)
            j += 1
        inner = [max(ss.values(), key=depth_of) for ss in open_.values()
                 if ss]
        segments.append((a, b, inner))
    own, inside = {}, {}

    def add(table, name, secs):
        table[name] = table.get(name, 0.0) + secs

    seg_starts = [a for a, _, _ in segments]
    for a, b in idle:
        covered = 0
        k = max(bisect.bisect_right(seg_starts, a) - 1, 0)
        while k < len(segments) and segments[k][0] < b:
            sa, sb, inner = segments[k]
            ov = min(b, sb) - max(a, sa)
            k += 1
            if ov <= 0 or not inner:
                continue
            covered += ov
            for s in inner:
                add(own, s["name"], ov / len(inner) / 1e9)
                for name in chain(s):
                    add(inside, name, ov / len(inner) / 1e9)
        if b - a > covered:
            add(own, NO_SPAN, (b - a - covered) / 1e9)
            add(inside, NO_SPAN, (b - a - covered) / 1e9)
    return own, inside


def clock_check(events, spans, shift):
    """Each K3 kernel against the ``whitted.intersect`` span that launched
    it (the span holding the kernel's launch call, matched by the CUDA
    correlation id; where no launch call matches, the kernels and spans in
    order when their numbers agree): (kernels, [kernel start - span start,
    ns] as the profiler stamped the kernel, the same moved onto the host's
    clock by ``shift``, [launch start - span start, ns]); None where there
    is no K3 kernel or no such span."""
    from torch.autograd import DeviceType

    calls = _calls(events)
    kern = sorted((e.start_ns(), e.correlation_id()) for e in events
                  if e.device_type() == DeviceType.CUDA
                  and CLOCK_KERNEL in e.name())
    sp = sorted((s["start_ns"], s["end_ns"]) for s in spans
                if s["name"] == CLOCK_SPAN)
    if not kern or not sp:
        return None
    starts = [a for a, _ in sp]
    pairs, launch_lead = [], []
    for k0, corr in kern:
        at = calls.get(corr)
        if at is None:
            continue
        j = bisect.bisect_right(starts, at) - 1
        if j >= 0 and at <= sp[j][1]:
            pairs.append((k0, sp[j][0]))
            launch_lead.append(at - sp[j][0])
    if not pairs and len(kern) == len(sp):
        pairs = [(k0, s0) for (k0, _), (s0, _) in zip(kern, sp)]
    raw = [k0 - s0 for k0, s0 in pairs]
    moved = [k0 - int(d) - s0 for (k0, s0), d in zip(
        pairs, shift(np.array([k0 for k0, _ in pairs], dtype=np.float64)))]
    return len(kern), raw, moved, launch_lead


def _quantiles_us(xs):
    s = sorted(xs)
    return {"median_us": statistics.median(s) / 1e3,
            "p1_us": s[int(0.01 * (len(s) - 1))] / 1e3}


def summary(timed, traced, events, window, count, unit):
    """The summary dict of one stretch (the module's docstring)."""
    span_ms, span_median_ms = span_times(timed, count)
    lags = _lags(events, _calls(events))
    shift = clock_shift(lags)
    idle = idle_intervals(host_aligned(events, shift), window[0], window[1])
    own, inside = attribute(idle, traced["spans"])
    out = dict(unit=unit, units=count, span_ms=span_ms,
               span_median_ms=span_median_ms,
               counts=counters(timed, count),
               idle_s=sum(b - a for a, b in idle) / 1e9,
               window_s=(window[1] - window[0]) / 1e9,
               idle=own, idle_in=inside)
    if lags:
        sh = shift(np.array([t for t, _ in lags], dtype=np.float64))
        out["clock"] = dict(
            device_after_call=_quantiles_us([x for _, x in lags]),
            shift_us=[float(sh.min()) / 1e3, float(sh.max()) / 1e3])
    k3 = clock_check(events, traced["spans"], shift)
    if k3 is not None:
        n, raw, moved, launch_lead = k3
        out["clock"] = dict(out.get("clock", {}), kernels=n,
                            matched=len(raw))
        if raw:
            out["clock"]["k3_after_span"] = _quantiles_us(raw)
            out["clock"]["k3_after_span_moved"] = _quantiles_us(moved)
        if launch_lead:
            out["clock"]["launch_after_span"] = _quantiles_us(launch_lead)
    return out


def lines(out):
    """Standard-error lines of a summary."""
    u = out["unit"]
    res = [f"program tracing: {out['on_s']:.6f} s a {u}, "
           f"{out['off_s']:.6f} s off"]
    total = out["idle_s"]
    top = sorted(out["idle"].items(), key=lambda kv: -kv[1])[:10]
    res.append(f"program idle: {total:.6f} s over {out['units']} {u}s "
               f"(window {out['window_s']:.6f} s); by innermost span: "
               + ", ".join(f"{k} {v:.6f} s ({v / total:.3f})"
                           for k, v in top) if total else "program idle: 0")
    res.append(f"program counters a {u}: " + ", ".join(
        f"{k} {v:g}" for k, v in sorted(out["counts"].items())))
    res.append(f"program spans, host ms a {u}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(out["span_ms"].items())))
    if "clock" in out:
        res.append(f"program clock: {out['clock']}")
    return res


def read(obs, unit):
    """``obs["program"]`` of a run whose units are ``unit``, or None."""
    prog = obs.get("program")
    return prog if prog and prog.get("unit") == unit else None
