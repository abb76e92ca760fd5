# -*- coding: utf-8 -*-
"""Per-phase wall-clock timers (plan / mesh / stage / solve / readout).

The reference only reports a single end-to-end elapsed time (remo3d.py:754,881);
first-class phase timing is one of the aux subsystems we add (SURVEY.md §5).
A copy of ``remo3d_tpu.utils.timers``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimers:
    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
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
