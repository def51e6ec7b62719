"""Spans and counters of the program's host work, and the one helper
that counts a kernel wrapper's launches.

``span(name)`` is a context manager around a piece of host work;
``count(name, n)`` adds ``n`` to a counter. Off (the default) each does
one cheap check, whether it is armed or a ``torch.profiler`` is
recording, and records nothing: ``span`` returns a shared no-op context
and never enters ``torch.profiler.record_function``. Armed, a span
appends one ``Span`` to an in-memory record when it ends (its name,
thread, start and end on ``time.perf_counter_ns``, the span that
encloses it on the same thread, and the unit of work it belongs to), and
a count one ``Count``. While a profiler is recording, the spans are
armed and each is also a ``record_function`` range, so it lands in the
profiler's trace beside the device rows, on the trace's own clock.
``enable()`` / ``disable()`` arm them without a profiler.

The unit of work is a training step or a decode batch: a span named in
``UNITS`` opens a new unit, and every span and count after it, on any
thread (the autograd engine's too), carries that unit's number until the
next one opens.

The record holds at most ``CAP`` entries (those past it are counted in
``dropped``), so that an armed long run cannot grow without bound.
``read()`` returns what it holds without clearing it; ``clear()`` empties
it.

Names go by layer: ``feed.*`` and ``decode.*`` (the CLI loop and feed),
``train.*`` and ``opt.*`` (trainer and optimizer), ``glue.*`` (models
and autograd glue), ``launch.*`` (the kernels' host side); the counter
``host_wait`` counts the blocking copies the hot path makes (a copy
from pageable memory to the card waits for the card's queue to drain).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter
from typing import Dict, List, NamedTuple, Optional

import torch
from torch._C._autograd import _profiler_enabled

CAP = 1 << 19
UNITS = ("train.step", "decode.batch")


class Span(NamedTuple):
    id: int
    name: str
    thread: int            # the thread's native id
    start_ns: int
    end_ns: int
    parent: Optional[int]  # the enclosing span's id on the same thread
    unit: int


class Count(NamedTuple):
    name: str
    thread: int
    t_ns: int
    n: int
    unit: int


class Reading(NamedTuple):
    """What the record held when ``read()`` was called."""
    spans: List[Span]
    counts: List[Count]
    dropped: int

    def self_ns(self) -> Dict[str, int]:
        """Each span name's self time summed over every thread: a span's
        duration less that of the spans it encloses on its thread."""
        inner: Counter = Counter()
        for s in self.spans:
            if s.parent is not None:
                inner[s.parent] += s.end_ns - s.start_ns
        out: Counter = Counter()
        for s in self.spans:
            out[s.name] += s.end_ns - s.start_ns - inner[s.id]
        return dict(out)

    def total(self, name: str) -> int:
        """The sum of the counts of ``name``."""
        return sum(c.n for c in self.counts if c.name == name)

    def units(self, name: str) -> int:
        """How many spans named ``name`` ended."""
        return sum(1 for s in self.spans if s.name == name)


_record: list = []
_dropped = 0
_armed = False
_unit = 0
_ids = itertools.count()
_local = threading.local()


def _thread():
    """This thread's open spans (``stack``) and native id (``tid``)."""
    if not hasattr(_local, "stack"):
        _local.stack, _local.tid = [], threading.get_native_id()
    return _local


def _append(entry) -> None:
    global _dropped
    if len(_record) < CAP:
        _record.append(entry)
    else:
        _dropped += 1


_OFF = contextlib.nullcontext()   # every span that is off


class _Span:
    __slots__ = ("name", "id", "parent", "unit", "tid", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _unit
        if self.name in UNITS:
            _unit += 1
        thread = _thread()
        stack = thread.stack
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.unit, self.tid = _unit, thread.tid
        stack.append(self.id)
        self.range = None
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        _append(Span(self.id, self.name, self.tid, self.start, end,
                     self.parent, self.unit))


def armed() -> bool:
    """Whether spans and counts are recorded now: ``enable()`` was
    called, or a profiler is recording."""
    return _armed or _profiler_enabled()


def span(name: str):
    """A context manager around host work named ``name`` (off: a shared
    no-op)."""
    if _armed or _profiler_enabled():
        return _Span(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (off: nothing)."""
    if _armed or _profiler_enabled():
        _append(Count(name, _thread().tid, time.perf_counter_ns(), n, _unit))


def enable() -> None:
    global _armed
    _armed = True


def disable() -> None:
    global _armed
    _armed = False


def read() -> Reading:
    """The spans and counts recorded so far (the record is kept)."""
    entries = list(_record)
    return Reading([e for e in entries if isinstance(e, Span)],
                   [e for e in entries if isinstance(e, Count)], _dropped)


def clear() -> None:
    global _dropped
    _record.clear()
    _dropped = 0


def count_launch(wrapper, shape: str, route: Optional[str] = None) -> None:
    """One launch of a kernel wrapper: in its ``launches``, in
    ``launches_by_shape[shape]`` and, where the wrapper picks among
    routes, in ``launches_by_route[route]``."""
    wrapper.launches += 1
    by_shape = wrapper.launches_by_shape
    by_shape[shape] = by_shape.get(shape, 0) + 1
    if route is not None:
        by_route = wrapper.launches_by_route
        by_route[route] = by_route.get(route, 0) + 1
