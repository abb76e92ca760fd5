"""The idle time credited to the program's spans (``h100_bench/spans.py``): on
hand-made spans and device activities against seconds worked out by hand,
and in a CPU run of each cell, where no device activity makes every new
metric absent."""

import collections
import time

import pytest

from h100_bench import spans
from h100_bench.tests.test_h100_bench_harness import CELLS, SMALL, run_ranks, small
from h100_bench.trace import Stretch

Span = collections.namedtuple("Span", "id parent request name thread start_ns end_ns")
MS = 1_000_000
NEW = ("idle_prep_s_per_log.2d", "idle_prep_s_per_log.3d", "idle_cg_s_per_log.3d",
       "idle_factor_s_per_step")


def caller_spans():
    """A log [0, 100] ms: "plan" [0, 10], "solve" [20, 80] holding "cg" [30,
    60], "readout" [80, 90]; a second root "set_model_parameters" [105,
    110]; a span of another thread; a root of an earlier profile."""
    return [
        Span(1, None, 1, "log", 7, -1000 * MS, -900 * MS),  # an earlier profile's
        Span(3, 2, 2, "plan", 7, 0, 10 * MS),
        Span(5, 4, 2, "cg", 7, 30 * MS, 60 * MS),
        Span(4, 2, 2, "solve", 7, 20 * MS, 80 * MS),
        Span(6, 2, 2, "readout", 7, 80 * MS, 90 * MS),
        Span(8, 2, 2, "mesh_ahead", 9, 5 * MS, 50 * MS),  # another thread: not the caller's
        Span(2, None, 2, "log", 7, 0, 100 * MS),
        Span(10, None, 10, "set_model_parameters", 7, 105 * MS, 110 * MS),
    ]


# Busy [5, 25], [35, 40], [50, 55], [85, 95] ms; idle in [0, 110]: [0, 5]
# (the edge: "plan"), [25, 35] ("solve" 5, "cg" 5), [40, 50] ("cg"), [55, 85]
# ("cg" 5, "solve" 20, "readout" 5), [95, 110] ("log" 5, between the roots
# "none" 5, "set_model_parameters" 5).
ACTIVITIES = [("k", 5 * MS, 25 * MS), ("k", 50 * MS, 55 * MS), ("k", 35 * MS, 40 * MS),
              ("k", 85 * MS, 95 * MS)]
WORKED = {"plan": 0.005, "solve": 0.025, "cg": 0.020, "readout": 0.005, "log": 0.005,
          "none": 0.005, "set_model_parameters": 0.005}


def test_idle_time_goes_to_the_innermost_span_of_the_caller():
    got = spans.credit(caller_spans(), ACTIVITIES, host_s=0.2)
    assert got.keys() == WORKED.keys()
    for name, seconds in WORKED.items():
        assert got[name] == pytest.approx(seconds, abs=1e-12), name


def test_an_activity_across_the_stretchs_edges_and_no_roots():
    # Busy over the whole of [0, 110] but for [60, 70] ("solve").
    acts = [("k", -5 * MS, 60 * MS), ("k", 70 * MS, 200 * MS)]
    assert spans.credit(caller_spans(), acts, host_s=0.2) == {"solve": pytest.approx(0.01)}
    assert spans.credit([s for s in caller_spans() if s.parent is not None], acts, 0.2) is None


def test_the_readers_divide_by_the_traced_requests(monkeypatch):
    from remo3d_tpu_torch.utils import timers

    monkeypatch.setattr(timers, "span_snapshot",
                        lambda: timers.SpanSnapshot(caller_spans(), 0))
    ctx = {"stretch": Stretch(ACTIVITIES, 0.2), "traced": [{}, {}]}
    assert spans.idle_prep_s_per_log(ctx) == pytest.approx(0.005 / 2)
    assert spans.idle_cg_s_per_log(ctx) == pytest.approx(0.020 / 2)
    assert spans.idle_factor_s_per_step(ctx) == 0.0
    assert spans.idle_by_span({"stretch": Stretch([], 0.2), "traced": [{}]}) is None
    assert spans.idle_by_span({"stretch": None, "traced": []}) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_of_each_cell_leaves_the_new_metrics_out(cell):
    from h100_bench import run

    spec = small(cell, SMALL[cell])
    if "ranks" in spec["traffic"]:  # its ranks, rank 0 in a process of its own
        out, err, code, _, _ = run_ranks(cell, SMALL[cell], 0.3, True, seed=2**31 + 11)
        assert code == 0 and out is not None, err[-3000:]
    else:
        out = run.run(spec, 2**31 + 11, 0.3, True, device="cpu", t_start=time.perf_counter())
    assert out["correct"]
    assert not set(NEW) & set(out["metrics"])
