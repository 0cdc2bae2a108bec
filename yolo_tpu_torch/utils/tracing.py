"""Spans inside the port: named, nested host intervals, with device times on CUDA.

Off by default. :func:`span` then checks one module-level flag and returns
one shared no-op context manager: no record, no CUDA event, and a graph
captured while the tracer is off has exactly the nodes it would have
without it. A harness turns it on around what it measures::

    tracing.enable()
    ...                       # set-up and the measured window
    taken = tracing.take()    # after the window's closing synchronize

When on, a span records its name, its parent (the span open on the same
thread when it began), the thread, and its host start and end from
``time.perf_counter_ns()``. Where CUDA is initialized it also records a
pair of timing events on the current stream; under a stream capture they
are external events, so they become event-record nodes of the graph and the
device time is measured again at every replay. Such spans go to the
collector of :func:`collecting`, and their device times are read through
:func:`replayed` and :func:`settle`. Each event node costs the card a few
microseconds at every replay, so ``serving.graphs.GraphedPredict`` captures
the callable twice, without a collector (a span under a capture outside a
collector records nothing and adds no node) and with one, and replays the
traced graph once in :data:`READ_EVERY` calls: each of its spans stands for
that many replays (its ``weight``).

Spans stay in memory in a bounded buffer; spans past the bound are counted
as dropped. Events are never waited for: eager ones are read in
:func:`take`, a replay's once it has completed and before its graph is
replayed again, and an event not yet complete then counts as unread. A
finished span is a plain tuple, which the garbage collector stops tracking,
so a long traced run does not lengthen its collections.

Counters stay plain integers on the objects that do the work
(``RequestBatcher.slots_dispatched``, ``GraphedPredict.replays``, the kernel
wrappers' ``LAUNCHES``); this module keeps spans only.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

#: Spans the buffer holds before it counts them as dropped.
CAPACITY = 1 << 20
#: Calls of a graphed callable of which one replays the graph that records its spans.
READ_EVERY = 8

_on = False
_lock = threading.Lock()
_buffer: list = []  # Span, or _Record while its events wait to be read
_pending: dict = {}  # id -> a replay's _Records not read yet
_dropped = 0
_unread = 0
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    """One finished span.

    ``start_ns`` / ``end_ns`` are ``time.perf_counter_ns()``; a replayed
    span (``replayed`` True) carries the host interval of the
    ``graphs.replay`` span that launched it, which is also its parent unless
    it was nested in another captured span. ``device_ms`` is the time
    between its two CUDA events, or None without events or when they were
    unread. ``weight`` is how many runs that device time stands for: 1, or
    for a replayed span :data:`READ_EVERY` (the replays of its graph that
    went unread since the last read one, and itself); a reader sums
    ``device_ms * weight``.
    """

    name: str
    id: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    device_ms: Optional[float]
    replayed: bool
    weight: int = 1


class Taken(NamedTuple):
    """What :func:`take` hands over: the spans (eager ones in the order they
    ended, replayed ones as they were read), the spans dropped past the
    bound, and the spans whose events were not complete when read."""

    spans: List[Span]
    dropped: int
    unread: int


class _Record:
    """A span whose CUDA events are still to be read."""

    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns", "events",
                 "captured")

    def __init__(self, name, parent, thread, start_ns, events, captured=False):
        self.name, self.id, self.parent, self.thread = name, next(_ids), parent, thread
        self.start_ns = self.end_ns = start_ns
        self.events, self.captured = events, captured

    def span(self, device_ms: Optional[float], weight: int = 0) -> Span:
        """The finished span; a ``weight`` makes it a replayed one."""
        return Span(self.name, self.id, self.parent, self.thread, self.start_ns, self.end_ns,
                    device_ms, weight > 0, max(weight, 1))


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


#: What :func:`span` returns while the tracer is off.
NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _push(item) -> None:
    global _dropped
    with _lock:
        if len(_buffer) < CAPACITY:
            _buffer.append(item)
        else:
            _dropped += 1


def _elapsed(events, done: bool = False) -> Optional[float]:
    """Milliseconds between two events if the second has completed (``done``
    says it has), else None and one more unread."""
    global _unread
    try:
        if done or events[1].query():
            return float(events[0].elapsed_time(events[1]))
    except RuntimeError:  # never recorded, or on two devices
        pass
    with _lock:
        _unread += 1
    return None


class _Span:
    __slots__ = ("name", "device", "record")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self) -> Optional[_Record]:
        cuda = self.device and torch.cuda.is_initialized()
        captured = cuda and torch.cuda.is_current_stream_capturing()
        if captured and getattr(_local, "collector", None) is None:
            self.record = None  # a graph that keeps no spans gets no node
            return None
        events = ((torch.cuda.Event(enable_timing=True, external=captured),
                   torch.cuda.Event(enable_timing=True, external=captured)) if cuda else None)
        stack = _stack()
        rec = self.record = _Record(self.name, stack[-1].id if stack else None,
                                    threading.get_ident(), time.perf_counter_ns(), events,
                                    captured)
        stack.append(rec)
        if events is not None:
            events[0].record()
        return rec

    def __exit__(self, *exc):
        rec = self.record
        if rec is None:
            return False
        if rec.events is not None:
            rec.events[1].record()
        rec.end_ns = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        collector = getattr(_local, "collector", None)
        if rec.captured and collector is not None:
            collector.append(rec)
        else:
            _push(rec if rec.events is not None else rec.span(None))
        return False


def span(name: str, device: bool = True):
    """A context manager timing the block as the span ``name``; with the
    tracer off, the shared :data:`NO_SPAN`. ``as`` binds the record (None
    when off, or under a stream capture outside :func:`collecting`).
    ``device=False`` records host times only and makes no CUDA call, for a
    span whose readers read its host interval alone."""
    if not _on:
        return NO_SPAN
    return _Span(name, device)


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start recording, keeping at most :data:`CAPACITY` spans until :func:`take`."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`take`."""
    global _on
    _on = False


def record(name: str, start_ns: int, end_ns: int) -> None:
    """A host-only span with explicit ``perf_counter_ns`` times, for an
    interval that starts on one thread and ends on another (no parent)."""
    if _on:
        _push(Span(name, next(_ids), None, threading.get_ident(), int(start_ns), int(end_ns),
                   None, False))


@contextlib.contextmanager
def collecting():
    """``with collecting() as spans:`` sends the captured spans that end on
    this thread inside the block to the list ``spans`` instead of the buffer."""
    outer = getattr(_local, "collector", None)
    _local.collector = []
    try:
        yield _local.collector
    finally:
        _local.collector = outer


def replayed(captured: list, replay: Optional[_Record]) -> list:
    """The spans of one replay of a graph whose capture collected
    ``captured``, under ``replay`` (the ``graphs.replay`` span that launched
    it), to be read by :func:`settle` before the graph is replayed again, or
    by :func:`take`. Empty when the tracer is off or ``replay`` is None."""
    if not _on or replay is None or not captured:
        return []
    ids = {}
    out = []
    for rec in captured:  # in the order they ended: a child before its parent
        new = _Record(rec.name, None, replay.thread, replay.start_ns, rec.events)
        new.end_ns = replay.end_ns
        ids[rec.id] = new
        out.append(new)
    for rec, new in zip(captured, out):
        outer = ids.get(rec.parent)
        new.parent = outer.id if outer is not None else replay.id
    with _lock:
        _pending[id(out)] = out
    return out


def settle(records: list, force: bool = True) -> None:
    """Read the device times of one replay's spans (:func:`replayed`); never
    waits. The last span to end is queried once for the whole replay. If it
    has not completed, ``force`` reads what has and counts the rest unread
    (before the graph records its events anew); without ``force`` the spans
    stay pending. Each span stands for :data:`READ_EVERY` replays."""
    if not records:
        return
    done = records[-1].events[1].query()
    if not (done or force):
        return
    with _lock:
        if _pending.pop(id(records), None) is None:
            return
    for rec in records:
        _push(rec.span(_elapsed(rec.events, done), READ_EVERY))
    records.clear()


def take() -> Taken:
    """Every finished span since the last take, with eager events and the
    last replays' read now (not waited for); empties the buffer and resets
    the dropped and unread counts."""
    global _buffer, _dropped, _unread
    with _lock:
        pending = list(_pending.values())
    for records in pending:
        settle(records)
    with _lock:
        items, _buffer = _buffer, []
        dropped, _dropped = _dropped, 0
    spans = [item if isinstance(item, Span) else item.span(_elapsed(item.events))
             for item in items]
    with _lock:
        unread, _unread = _unread, 0
    return Taken(spans, dropped, unread)
