# -*- coding: utf-8 -*-
"""Per-phase wall-clock timers (plan / mesh / stage / solve / readout) and the
spans they record.

The reference only reports a single end-to-end elapsed time (remo3d.py:754,881);
first-class phase timing is one of the aux subsystems we add (SURVEY.md §5).
A copy of ``remo3d_tpu.utils.timers``, safe to time from several threads (the
executor's pipeline meshes on one of its own): phases of different threads
overlap in time, so their seconds may sum to more than the wall. A thread
that times inside :meth:`PhaseTimers.suffixed` gets its own names for them.

Every phase is a :func:`span`. A span opened inside another span on the same
thread is its child, and counts as a phase of the parent's timers when it
names none of its own. Phases and spans are timed by ``time.time_ns()``, the
Unix-epoch clock of the profiler's events. While a torch profiler records on
the thread that opens a request's root span (the outermost span of a
thread), every span of that request is kept: its id, its parent's, the
request's (the root's id), its name, its thread and its start and end, in one
bounded buffer that :func:`span_snapshot` reads. Each span opened on a
profiling thread is also a ``torch.profiler.record_function`` range under its
label, so a Chrome trace shows it beside the kernels. A request's work on
another thread (the executor's read-ahead) enters the request's context
(:func:`request_context`, :func:`entered`), so its spans are kept and carry
the request's id. With no profiler nothing is kept.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

MAX_SPANS = 100_000  # the buffer's bound: the oldest spans are dropped
LABEL_PREFIX = "remo3d_tpu_torch."


@dataclasses.dataclass(frozen=True)
class Span:
    id: int
    parent: int | None  # None for a root span
    request: int  # the id of the root span it descends from
    name: str
    thread: int  # threading.get_ident() of the thread that ran it
    start_ns: int  # time.time_ns()
    end_ns: int
    attrs: dict  # figures the code put on it (the CG loop's iterations, ...)


class SpanSnapshot(NamedTuple):
    spans: list  # of Span, oldest first
    dropped: int  # spans dropped from the full buffer since the process started


class _Open:
    """A span open on a thread's stack. Handed to another thread, it is the
    context of the request: its id is the parent of the spans opened there."""

    __slots__ = ("id", "request", "recording", "timers", "attrs")

    def __init__(self, id_, request, recording, timers):
        self.id, self.request, self.recording, self.timers = id_, request, recording, timers
        self.attrs = {}


_ids = itertools.count(1)
_local = threading.local()
_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_buffer_lock = threading.Lock()
_dropped = 0


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _profiling() -> bool:
    """Whether a torch profiler records on this thread."""
    return torch._C._autograd._profiler_enabled()


def _keep(span: Span) -> None:
    global _dropped
    with _buffer_lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(span)


def span_snapshot() -> SpanSnapshot:
    """The spans kept so far, oldest first, and the count of those dropped."""
    with _buffer_lock:
        return SpanSnapshot(list(_buffer), _dropped)


def request_context():
    """The innermost span open on this thread, or None: the context to hand
    to work done for the same request on another thread (:func:`entered`)."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def entered(context):
    """Spans opened on this thread inside the block are children of
    ``context`` (from :func:`request_context` on another thread; None changes
    nothing), kept when its request is."""
    if context is None:
        yield
        return
    stack = _stack()
    stack.append(context)
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def span(name: str, *, label: str | None = None, timers: PhaseTimers | None = None):
    """A span named ``name`` around the block, which gets its ``attrs`` dict.
    Its seconds count as the phase ``name`` of ``timers`` (by default the
    timers of the innermost span open on this thread, if any). ``label``
    names its profiler range (default ``remo3d_tpu_torch.<name>``)."""
    stack = _stack()
    top = stack[-1] if stack else None
    if timers is None and top is not None:
        timers = top.timers
    annotate = _profiling()
    id_ = next(_ids)
    this = _Open(id_, top.request if top else id_, annotate or bool(top and top.recording), timers)
    outer = timers is not None and not any(f.timers is timers for f in stack)
    stack.append(this)
    rf = None
    if annotate:
        rf = torch.profiler.record_function(label or LABEL_PREFIX + name)
        rf.__enter__()
    start_ns = time.time_ns()
    try:
        yield this.attrs
    finally:
        end_ns = time.time_ns()
        if rf is not None:
            rf.__exit__(None, None, None)
        if this.recording:
            _keep(Span(this.id, top.id if top else None, this.request, name,
                       threading.get_ident(), start_ns, end_ns, this.attrs))
        stack.pop()
        if timers is not None:
            timers._add(name, (end_ns - start_ns) / 1e9, outer)


class PhaseTimers:
    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._outermost = 0.0  # seconds of the phases inside no other of these timers
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextlib.contextmanager
    def suffixed(self, suffix: str):
        """Phases this thread times inside the block are named with ``suffix``
        appended (the executor's pipeline: "mesh_ahead")."""
        self._local.suffix = suffix
        try:
            yield
        finally:
            self._local.suffix = ""

    def phase(self, name: str, label: str | None = None):
        """The block as the phase ``name``: a :func:`span` of these timers."""
        return span(name + getattr(self._local, "suffix", ""), label=label, timers=self)

    def _add(self, name: str, seconds: float, outermost: bool) -> None:
        with self._lock:
            self.seconds[name] += seconds
            self.counts[name] += 1
            if outermost:
                self._outermost += seconds

    def report(self) -> str:
        """The phases by seconds; the total leaves out phases nested in others."""
        lines = [
            f"  {name:<10s} {secs:8.3f}s  ({self.counts[name]}x)"
            for name, secs in sorted(self.seconds.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join([f"phase timings (total {self._outermost:.3f}s):"] + lines)
