"""What every traffic kind shares: the run's context, seeds, the closed
loop's clock, the checks that decide ``correct``, the device record, the
per-layer readers and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "distributionraytracer_tpu")


def process_start():
    """Wall-clock seconds at which this process started (Linux): its start
    in clock ticks since boot, against the seconds since boot."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def derive_seed(seed, *keys):
    """A 63-bit seed for ``torch.Generator`` from the run's seed and
    ``keys`` (a frame, a step, a purpose)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64)]
                                   + [int(k) for k in keys]).generate_state(2)
    return (int(state[0]) << 31 | int(state[1]) >> 1) & ((1 << 63) - 1)


def rng(seed, *keys):
    return np.random.default_rng(derive_seed(seed, *keys))


class Context:
    """One run: its cell, configuration, seed, window and device.
    ``overrides`` (tests only) replace configuration keys, such as the
    resolution, so that a run fits a CPU."""

    def __init__(self, workload, seed, seconds, trace, device="cuda",
                 overrides=None, t_start=None):
        self.workload = load_json("workloads", workload + ".json")
        self.name = workload
        cfg = load_json("configs", self.workload["config"] + ".json")
        cfg.update(overrides or {})
        self.config = cfg
        self.params = dict(self.workload.get("params", {}))
        self.params.update((overrides or {}).get("params", {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = process_start() if t_start is None else t_start
        self.spans = {}  # span name: [seconds, ...]
        self.excluded = 0.0  # set-up seconds spent on the reference
        self.phases = []  # (set-up phase, seconds since the process start)

    def span(self, name, seconds):
        self.spans.setdefault(name, []).append(seconds)

    def mark(self, phase):
        """Record that set-up ``phase`` has ended (printed on stderr)."""
        self.phases.append((phase, time.time() - self.t_start))

    def exclude(self, seconds):
        """Leave ``seconds`` the reference took during set-up (making an
        input both sides get, such as a target image) out of ``setup_s``."""
        self.excluded += seconds

    def sync(self):
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def setup_s(self):
        """Seconds from the process start to now, less the reference's."""
        self.mark("window start")
        return time.time() - self.t_start - self.excluded


def closed_loop(seconds, unit):
    """Run ``unit(i)`` back to back until ``seconds`` have passed; each
    call ends with its result on the host.  Returns (units done, the
    window's seconds from its start to the last unit's end)."""
    t0 = time.perf_counter()
    i, end = 0, t0
    while end - t0 < seconds:
        unit(i)
        i += 1
        end = time.perf_counter()
    return i, end - t0


class Checks:
    """The numbers compared with the reference, each beside its limit; a
    number passes when it is at most its limit.  A number that could not
    be computed (None, NaN) fails."""

    def __init__(self):
        self.items = []

    def add(self, name, value, limit):
        self.items.append((name, None if value is None else float(value),
                           float(limit)))

    @property
    def correct(self):
        return bool(self.items) and all(
            v is not None and v == v and v <= lim for _, v, lim in self.items)

    def as_dict(self):
        return {n: {"value": v, "limit": lim} for n, v, lim in self.items}

    def numbers(self):
        return {n: v for n, v, _ in self.items}

    def lines(self):
        return [f"check {n}: {v!r} (limit {lim!r}) "
                + ("ok" if v is not None and v == v and v <= lim else "FAIL")
                for n, v, lim in self.items]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def readers():
    """{metric name: module} of every per-layer reader in ``metrics/``."""
    out = {}
    mdir = os.path.join(HERE, "metrics")
    for fn in sorted(os.listdir(mdir)):
        if not fn.endswith(".py") or fn.startswith("_"):
            continue
        name = fn[:-3]
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_"),
            os.path.join(mdir, fn))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def read_metrics(obs):
    """The per-layer metrics whose readers find something in ``obs``."""
    out = {}
    for name, mod in readers().items():
        v = mod.read(obs)
        if v is not None:
            out[name] = {"value": float(v), "unit": mod.UNIT}
    return out


def median(xs):
    return statistics.median(xs) if xs else None


def p95(xs):
    """The 95th percentile of all ``xs`` (nearest rank)."""
    if not xs:
        return None
    s = sorted(xs)
    return s[max(int(np.ceil(0.95 * len(s))) - 1, 0)]


@dataclasses.dataclass
class Outcome:
    """What a traffic kind hands back to the runner."""

    attempted: int
    failed: int
    end_to_end: Dict[str, Tuple[float, str]]
    checks: Checks
    memory_peak_bytes: int
    obs: dict = dataclasses.field(default_factory=dict)
    profile: Optional[dict] = None
