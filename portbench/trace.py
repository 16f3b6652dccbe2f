"""A profiled stretch: ``torch.profiler`` over a few units of a cell's
work, read from the profiler's raw events (building FunctionEvents for
hundreds of thousands of host events would take minutes).

What it gives the per-layer readers (``summary``):

- ``window_s``: the stretch's wall seconds (host clock, ending in a
  synchronise); ``units``: the units of work it covered;
- ``busy_s``: the union of the device activity intervals in it;
- ``device``: {activity name: [count, seconds]};
- ``launch_calls``: host calls that put work on the device (kernel and
  graph launches, asynchronous copies and memsets), by name;
- ``idle_gaps``: {host op: seconds}: each gap between device activities
  of one more unit, profiled with its host ops, named by the host op that
  had last started before the gap.
"""

from __future__ import annotations

import bisect
import time

import torch

LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync")
# A device activity is PyTorch's own (or its libraries') when its name is a
# copy or memset, or names one of their namespaces; every other kernel is
# the program's own (its CUDA sources build one library of kernels).
TORCH_MARKS = ("Memcpy", "Memset", "at::", "c10::", "cub::", "thrust::",
               "cublas", "cutlass", "gemm", "cudnn", "nvjet", "xmma")


def is_torch(name):
    return any(m in name for m in TORCH_MARKS)


def _events(run, cpu):
    """(wall seconds, kineto events) of ``run()`` under the profiler, with
    host ops recorded only when ``cpu``."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return window, list(prof.profiler.kineto_results.events())


def _device(events):
    from torch.autograd import DeviceType

    return sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                  if e.device_type() == DeviceType.CUDA)


def profile(run_units, n_units):
    """Profile ``run_units(first, count)``: units 0..n_units-1 with the
    device's activities and the host's CUDA calls alone (host ops are not
    recorded: recording them slows a host-bound unit several times), then
    unit n_units once more with host ops, whose idle gaps it names.
    Returns the summary dict."""
    window, events = _events(lambda: run_units(0, n_units), cpu=False)
    device = _device(events)
    launches = {}
    for e in events:
        name = e.name()
        if any(k in name for k in LAUNCH_CALLS):
            launches[name] = launches.get(name, 0) + 1
    busy, end, by_name = 0, None, {}
    for a, b, name in device:
        n, s = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, s + (b - a) / 1e9)
        busy += max(b - (a if end is None else max(a, end)), 0)
        end = b if end is None else max(end, b)
    from torch.autograd import DeviceType

    _, events = _events(lambda: run_units(n_units, 1), cpu=True)
    dev1 = _device(events)
    host = sorted((e.start_ns(), e.name()) for e in events
                  if e.device_type() != DeviceType.CUDA
                  and not e.name().startswith("cu"))
    starts = [a for a, _ in host]
    gaps, end = {}, None
    for a, b, _ in dev1:
        if end is not None and a > end:
            j = bisect.bisect_right(starts, end) - 1
            what = host[j][1] if j >= 0 else "(before the first host op)"
            gaps[what] = gaps.get(what, 0.0) + (a - end) / 1e9
        end = b if end is None else max(end, b)
    return dict(window_s=window, units=n_units, busy_s=busy / 1e9,
                device={k: list(v) for k, v in by_name.items()},
                launch_calls=launches, idle_gaps=gaps)


def breakdown(summary):
    """The ten device activities that took most time and the ten longest
    idle-gap totals, as [[name, seconds], ...]."""
    top = sorted(summary["device"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v[1]] for k, v in top],
            "idle_gaps": [[k[:120], v] for k, v in gaps]}


def idle_share(obs, unit):
    """1 - (device busy seconds a unit of the profiled stretch) / (the
    unprofiled window's seconds a unit), for a run whose units are
    ``unit``; None where there is nothing to read."""
    prof = obs.get("profile")
    if (obs.get("unit") != unit or not prof or not prof["units"]
            or not obs.get("unit_s")):
        return None
    return 1.0 - prof["busy_s"] / prof["units"] / obs["unit_s"]


def device_seconds(summary, marks):
    """Summed device seconds of the activities whose name holds one of
    ``marks``; None when none ran."""
    hits = [v[1] for k, v in summary["device"].items()
            if any(m in k for m in marks)]
    return sum(hits) if hits else None
