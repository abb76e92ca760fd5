# -*- coding: utf-8 -*-
"""Per-phase wall-clock timers (plan / mesh / stage / solve / readout).

The reference only reports a single end-to-end elapsed time (remo3d.py:754,881);
first-class phase timing is one of the aux subsystems we add (SURVEY.md §5).
A copy of ``remo3d_tpu.utils.timers``, safe to time from several threads (the
executor's pipeline meshes on one of its own): phases of different threads
overlap in time, so their seconds may sum to more than the wall. A thread
that times inside :meth:`PhaseTimers.suffixed` gets its own names for them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class PhaseTimers:
    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
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

    @contextlib.contextmanager
    def phase(self, name: str):
        name += getattr(self._local, "suffix", "")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            seconds = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] += seconds
                self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.seconds.values())
        lines = [
            f"  {name:<10s} {secs:8.3f}s  ({self.counts[name]}x)"
            for name, secs in sorted(self.seconds.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join([f"phase timings (total {total:.3f}s):"] + lines)

    def reset(self):
        self.seconds.clear()
        self.counts.clear()
