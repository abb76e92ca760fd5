# -*- coding: utf-8 -*-
"""The traced stretch of a run: torch.profiler over a few requests inside the
window, device activities only, kept in memory and read from the profiler's
raw events (its event tree would take minutes for the 10^5 activities of a
3D log; ``remo3d_tpu_torch/bench.py``'s reader at 214ab07, frozen here)."""

from __future__ import annotations

import collections
import dataclasses

import torch

NAME_CHARS = 120  # kernel names are cut here (templates run to 1000s)
LABEL_CHARS = 60
TOP = 10


@dataclasses.dataclass
class Stretch:
    """What the profiler saw: device activities (name, start ns, end ns) and
    the host's seconds of the stretch."""

    activities: list
    host_s: float

    def busy_s(self) -> float:
        """Seconds in which some activity ran: the union of the intervals."""
        return sum(e - s for s, e in self._merged()) / 1e9

    def seconds_of(self, names) -> float:
        """Device seconds of the activities whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.activities if any(k in n for k in names)) / 1e9

    def top_ops(self) -> list:
        by_name = collections.defaultdict(int)
        for n, s, e in self.activities:
            by_name[n[:NAME_CHARS]] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, ns / 1e9] for n, ns in top]

    def idle_gaps(self) -> list:
        """The longest idle gaps between device activities, each labelled by
        the activities on either side (a device-to-host copy before a gap is
        the host reading a result; the host's phases are not in a profile of
        device activities), and the idle time of the stretch before the first
        and after the last activity."""
        spans = sorted(self.activities, key=lambda a: a[1])
        gaps, end, last = [], None, None
        for n, s, e in spans:
            if end is not None and s > end:
                gaps.append([f"after {last[:LABEL_CHARS]} | before {n[:LABEL_CHARS]}",
                             (s - end) / 1e9])
            if end is None or e >= end:
                end, last = e, n
        if spans:
            edge = self.host_s - (end - spans[0][1]) / 1e9
            gaps.append(["before the first and after the last device activity", edge])
        gaps.sort(key=lambda g: -g[1])
        return gaps[:TOP]

    def _merged(self) -> list:
        out = []
        for _, s, e in sorted(self.activities, key=lambda a: a[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out


def read(prof, host_s: float) -> Stretch:
    """The device activities of a finished profile (the device-side spans of
    annotation ranges, where any were recorded, left out)."""
    events = prof.profiler.kineto_results.events()
    ranges = {e.name() for e in events if e.is_user_annotation()}
    return Stretch([(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                    if e.device_type() == torch.autograd.DeviceType.CUDA
                    and e.name() not in ranges], host_s)


def profiler(on_cuda: bool = True):
    from torch.profiler import ProfilerActivity, profile

    # Device activities only: recording every host op too slows the host
    # that feeds the card. (A run on the CPU, for the tests, records host ops
    # and finds no device activity.)
    return profile(activities=[ProfilerActivity.CUDA if on_cuda else ProfilerActivity.CPU])
