"""The port's span and counter recorder, off unless :func:`enable` is called.

A span records where a layer's host work starts and ends::

    from distributionraytracer_tpu_torch.utils import spans

    with spans.span("render.tile"):
        ...
    spans.count("whitted.lanes", R * n)           # a host integer
    spans.count_device("whitted.lanes_live", fv.sum())  # a count on the card

Each span keeps its name, its parent span, its unit and its start and end
(``time.perf_counter_ns``).  A unit is one outermost span and everything
under it (a frame, a request, a step): its id is the ordinal of that
outermost span.  Each thread has its own stack of open spans, so the
viewer's request threads never nest under one another.  A count belongs to
the unit open on its thread (None outside any unit).  Device counts are
summed on their device and read to the host once, when the unit's
outermost span closes (or by :func:`collect`, for counts outside a unit).

:func:`enable` takes one anchor pair ``(time.time_ns(),
time.perf_counter_ns())``; :func:`collect` maps every stamp through it to
Unix-epoch nanoseconds, the clock of ``torch.profiler``'s events, so that
spans can be laid over a device trace.

Off (the default), :func:`span` returns one shared no-op context manager and
:func:`count` and :func:`count_device` return at once: no tensor op, no
allocation, no lock and no read from the card.  Inside :func:`paused`, the
calling thread records as if the recorder were off.
"""

from __future__ import annotations

import itertools
import threading
import time

_on = False
_anchor = (0, 0)  # (time.time_ns(), time.perf_counter_ns()) at enable()
_spans = []  # (name, id, parent id, unit, thread id, start, end)
_counts = []  # (unit, name, host int)
_pending = []  # (name, tensor) device counts made outside any unit
_ids = itertools.count()
_units = itertools.count()
_local = threading.local()


def enable():
    """Turn the recorder on and take the clock anchor."""
    global _on, _anchor
    _anchor = (time.time_ns(), time.perf_counter_ns())
    _on = True


def disable():
    global _on
    _on = False


def enabled() -> bool:
    """Whether this thread records: the recorder is on and not
    :func:`paused`."""
    return _on and not getattr(_local, "paused", 0)


class paused:
    """A context manager under which this thread records nothing: for work
    that is not a unit's own, such as a CUDA graph's warm-up and capture,
    whose tensors are reused by every replay."""

    __slots__ = ()

    def __enter__(self):
        _local.paused = getattr(_local, "paused", 0) + 1
        return self

    def __exit__(self, *exc):
        _local.paused -= 1
        return False


class _Off:
    """The shared context manager of a span while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _state():
    st = _local.__dict__
    if "stack" not in st:
        st["stack"] = []  # open spans, innermost last
        st["device"] = []  # (name, tensor) device counts of the open unit
    return st


class _Span:
    """One open span.  ``seconds`` is its duration once it has closed; it
    is recorded only if the recorder was on when it opened."""

    __slots__ = ("name", "record", "id", "parent", "unit", "start",
                 "seconds")

    def __init__(self, name, record):
        self.name, self.record = name, record
        self.seconds = None

    def __enter__(self):
        if self.record:
            stack = _state()["stack"]
            self.id = next(_ids)
            if stack:
                self.parent, self.unit = stack[-1].id, stack[-1].unit
            else:
                self.parent, self.unit = None, next(_units)
            stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.seconds = (end - self.start) / 1e9
        if self.record:
            st = _state()
            st["stack"].pop()
            _spans.append((self.name, self.id, self.parent, self.unit,
                           threading.get_ident(), self.start, end))
            if not st["stack"] and st["device"]:
                _counts.extend((self.unit, name, n)
                               for name, n in _read(st["device"]))
                st["device"] = []
        return False


def span(name: str):
    """A context manager that records a span named ``name``; the shared
    no-op one while the recorder is off."""
    if not enabled():
        return _OFF
    return _Span(name, True)


def timed(name: str) -> _Span:
    """A span that always times itself (``.seconds`` after it closes) and
    is recorded only while the recorder is on: for a duration the program
    keeps whether or not anyone traces it."""
    return _Span(name, enabled())


def _unit():
    stack = _state()["stack"]
    return stack[-1].unit if stack else None


def count(name: str, n: int = 1):
    """Add the host integer ``n`` to the counter ``name`` of the open unit."""
    if not enabled():
        return
    _counts.append((_unit(), name, int(n)))


def count_device(name: str, tensor):
    """Add ``tensor`` (a 0-d int64 count on the unit's device) to the
    counter ``name``; it is summed on its device and read with the unit's
    other device counts when the unit's outermost span closes."""
    if not enabled():
        return
    stack = _state()["stack"]
    (_state()["device"] if stack else _pending).append((name, tensor))


def host_read(tensor, n: int = 1):
    """Count ``n`` reads of ``tensor`` from the card to the host
    (``sync.host_reads``); reads of a CPU tensor are no reads."""
    if enabled() and tensor.device.type != "cpu":
        count("sync.host_reads", n)


def _read(pending):
    """[(name, int)] of the summed device counts in ``pending``: one read
    to the host for all of them."""
    import torch

    by_name = {}
    for name, t in pending:
        by_name.setdefault(name, []).append(t)
    sums = [torch.stack(ts).sum() for ts in by_name.values()]
    return list(zip(by_name, torch.stack(sums).tolist()))


def collect() -> dict:
    """The records so far, cleared: ``{"spans": [...], "counts": [...]}``.
    A span is ``{"name", "id", "parent", "unit", "thread", "start_ns",
    "end_ns"}`` with stamps in Unix-epoch nanoseconds; a count is
    ``{"unit", "name", "n"}``, summed over the unit."""
    global _pending
    pending, _pending = _pending, []
    if pending:
        _counts.extend((None, name, n) for name, n in _read(pending))
    off = _anchor[0] - _anchor[1]
    spans = [dict(name=s[0], id=s[1], parent=s[2], unit=s[3], thread=s[4],
                  start_ns=s[5] + off, end_ns=s[6] + off)
             for s in _spans]
    totals = {}
    for unit, name, n in _counts:
        totals[unit, name] = totals.get((unit, name), 0) + n
    del _spans[:], _counts[:]
    return {"spans": spans,
            "counts": [dict(unit=u, name=k, n=n)
                       for (u, k), n in totals.items()]}
