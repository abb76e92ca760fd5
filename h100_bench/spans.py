# -*- coding: utf-8 -*-
"""The card's idle time in the traced stretch, credited to what the host was
doing: the program's spans (``remo3d_tpu_torch.utils.timers``, kept while the
profiler records). The program is imported inside the function, as the
entries import it; a program that keeps no spans gives None, as does a
stretch with no device activity."""

from __future__ import annotations

import collections

NONE = "none"  # idle time under no span of the caller's thread
# The host's work before a chunk reaches the card: planning, the executor's
# set-up, meshing, stacking, the wait for the read-ahead and the copies.
PREP = ("plan", "prepare", "mesh", "stack", "pipeline_wait", "stage")


def idle_by_span(ctx):
    """{span name: seconds} of the traced stretch's device idle time, from the
    start of the traced requests' first root span to the end of their last:
    each idle interval is split at the boundaries of the caller's spans (the
    thread of the root spans) and each piece credited to the innermost span
    open there, or to NONE."""
    stretch = ctx["stretch"]
    if stretch is None or not stretch.activities:
        return None
    try:
        from remo3d_tpu_torch.utils.timers import span_snapshot
    except ImportError:  # a program without spans
        return None
    return credit(span_snapshot().spans, stretch.activities, stretch.host_s)


def credit(spans, activities, host_s):
    """:func:`idle_by_span` of ``spans`` (the program's ``Span`` records) and
    ``activities`` ((name, start ns, end ns) on the same clock). The traced
    requests' root spans are the caller's thread's last ones, those that
    start within ``host_s`` seconds of the last one's end: the buffer may
    hold spans of earlier profiles."""
    roots = [s for s in spans if s.parent is None]
    if not roots:
        return None
    last = max(roots, key=lambda s: s.end_ns)
    since = last.end_ns - int(host_s * 1e9)
    roots = [s for s in roots if s.thread == last.thread and s.start_ns >= since]
    t0, t1 = min(s.start_ns for s in roots), last.end_ns
    mine = [s for s in spans if s.thread == last.thread and s.end_ns > t0 and s.start_ns < t1]
    idle, pieces = _idle(activities, t0, t1), _innermost(mine, t0, t1)
    out = collections.defaultdict(float)
    i = j = 0
    while i < len(idle) and j < len(pieces):
        (a0, a1), (b0, b1, name) = idle[i], pieces[j]
        if min(a1, b1) > max(a0, b0):
            out[name] += (min(a1, b1) - max(a0, b0)) / 1e9
        if a1 < b1:
            i += 1
        else:
            j += 1
    return dict(out)


def _idle(activities, t0, t1):
    """The intervals of [t0, t1] in which no activity ran, in order."""
    out, end = [], t0
    for _, s, e in sorted(activities, key=lambda a: a[1]):
        if s >= t1:
            break
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if end < t1:
        out.append((end, t1))
    return out


def _innermost(spans, t0, t1):
    """[(start, end, name)] covering [t0, t1] in order: each piece under the
    innermost of ``spans`` (one thread's, so they nest) open there."""
    out, stack, t = [], [], t0

    def upto(until, name):
        nonlocal t
        until = min(until, t1)
        if until > t:
            out.append((t, until, name))
            t = until

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns, s.id)):
        while stack and stack[-1].end_ns <= s.start_ns:
            upto(stack[-1].end_ns, stack.pop().name)
        upto(s.start_ns, stack[-1].name if stack else NONE)
        stack.append(s)
    while stack:
        upto(stack[-1].end_ns, stack.pop().name)
    upto(t1, NONE)
    return out


def _per_request(ctx, names):
    by = idle_by_span(ctx)
    if by is None or not ctx["traced"]:
        return None
    return sum(by.get(n, 0.0) for n in names) / len(ctx["traced"])


def rank_wait_s_per_log(since_ns: int):
    """Seconds per log, in this process, from the end of the log's last
    "readout" span to the end of its "log" root span, mean over the logs
    whose root span started at or after ``since_ns``: under several ranks,
    the wait for the slowest rank, the gather of the readouts and the
    failure counts' sum over the ranks. None without such logs."""
    try:
        from remo3d_tpu_torch.utils.timers import span_snapshot
    except ImportError:  # a program without spans
        return None
    return rank_wait(span_snapshot().spans, since_ns)


def rank_wait(spans, since_ns: int):
    """:func:`rank_wait_s_per_log` of ``spans`` (the program's ``Span`` records)."""
    roots = {s.id: s for s in spans if s.parent is None and s.name == "log"
             and s.start_ns >= since_ns}
    last = {}
    for s in spans:
        if s.name == "readout" and s.request in roots:
            last[s.request] = max(last.get(s.request, 0), s.end_ns)
    waits = [(roots[r].end_ns - end) / 1e9 for r, end in last.items()]
    return sum(waits) / len(waits) if waits else None


def idle_prep_s_per_log(ctx):
    """Device idle seconds per traced log under the caller's PREP spans."""
    return _per_request(ctx, PREP)


def idle_cg_s_per_log(ctx):
    """Device idle seconds per traced log under the caller's "cg" spans: the
    host's round trip between the CG graph's replays."""
    return _per_request(ctx, ("cg",))


def idle_factor_s_per_step(ctx):
    """Device idle seconds per traced step under the caller's "factor" spans
    (the block-direct factor of both calls, forward and Jacobian)."""
    return _per_request(ctx, ("factor",))
