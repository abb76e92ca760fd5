"""The harness's multi-process path (``h100_bench/ranks.py``) on the CPU: two
ranks over gloo, rank 0 in a process of its own, a small grid and a few
depths. A run is correct; a rank whose share of the log is altered or stale
is not, nor is a run whose ranks leave out their exchange; a rank that
raises, is killed or hangs ends the run within 60 s with no process left;
with fewer cards than ranks a run starts no rank and gives no line. The
stratified sample and the rank-wait reading, on made-up reports and
spans."""

import collections
import json

import numpy as np
import pytest

from h100_bench import drive, ranks, run, spans
from test_h100_bench_harness import BENCH, SMALL, gone, run_ranks, small

CELL = "example01_2d.ranks4"


def test_a_cpu_ranks_run_is_correct():
    out, err, code, _, pids = run_ranks(CELL, SMALL[CELL], seconds=1.0, trace=True)
    assert code == 0 and out is not None, err[-3000:]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 3
    assert out["device"]["count"] == 2 and list(out)[-1] == "checks"
    # Read from every rank's phases and spans; no card, so no idle share.
    assert {"plan_s_per_log.ranks4", "mesh_s_per_log.ranks4",
            "rank_wait_s_per_log.ranks4", "log_wall_p95.ranks4"} <= set(out["metrics"])
    assert "device_idle.ranks4" not in out["metrics"]
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert "ranks 0-1 on cpu cpu" in err
    assert len(pids) == 1 and all(gone(p) for p in pids)


def test_the_end_to_end_metrics_of_a_ranks_run():
    out, err, code, _, _ = run_ranks(CELL, SMALL[CELL], seconds=1.0)
    assert code == 0 and out["correct"], err[-3000:]
    assert set(out["metrics"]) == {"readouts_per_s.ranks4", "setup_s"}
    assert "breakdown" not in out and "busy_s" not in out["device"]


@pytest.mark.parametrize("fault", ["altered", "stale"])
def test_a_rank_with_a_wrong_share_is_not_correct(fault):
    out, err, code, _, pids = run_ranks(CELL, SMALL[CELL], seconds=1.0, child_fault=fault)
    assert code == 0 and out is not None, err[-3000:]
    assert out["failed"] == 0 and not out["correct"], out["checks"]
    assert all(gone(p) for p in pids)


def test_a_run_without_the_exchange_between_ranks_is_not_correct():
    out, err, code, _, _ = run_ranks(CELL, SMALL[CELL], seconds=1.0, fault="no_exchange",
                                     child_fault="no_exchange")
    assert code == 0 and out is not None, err[-3000:]
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("fault", ["raises", "killed", "hangs"])
def test_a_rank_that_fails_ends_the_run(fault):
    out, err, code, seconds, pids = run_ranks(CELL, SMALL[CELL], seconds=30.0,
                                              child_fault=fault, stall_s=10.0)
    assert seconds < 60, err[-3000:]
    assert code == 0 and out is not None, err[-3000:]
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"] == {"readout_gap": {"value": None, "limit": 0.002}}
    assert pids and all(gone(p) for p in pids)


def test_with_fewer_cards_than_ranks_no_rank_starts_and_no_line(monkeypatch, capsys):
    import subprocess

    import torch

    def refuse(*a, **k):
        raise AssertionError("a rank was started")

    for var in run.THREAD_VARS:  # main sets them; keep them to this test
        monkeypatch.setenv(var, "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    assert ranks.run(run.cell_spec(BENCH, CELL), 1, 1.0, False) is None
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1", "--trace", "0"]) == 1
    assert capsys.readouterr().out == ""


def _report(rows, chunk, solve=1):
    return {"chunk": chunk, "axes": {"batch": 2, "solve": solve},
            "chunks": [{"batches": b} for b in rows]}


def test_owners_follow_the_ranks_rows():
    # 11 batches in chunks of 4 over 2 ranks: 2 + 2, 2 + 2, 2 + 1.
    reports = [_report([2, 2, 2], 4), _report([2, 2, 1], 4)]
    assert ranks.owners(reports, 11) == [0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1]
    with pytest.raises(ValueError):
        ranks.owners(reports, 12)  # a batch no rank solved
    with pytest.raises(ValueError):
        ranks.owners([_report([2, 2, 2], 4), _report([2, 1, 1], 4)], 10)  # a short chunk
    with pytest.raises(ValueError):
        ranks.owners([_report([2, 2, 2], 4, 2), _report([2, 2, 1], 4, 2)], 11)


def test_the_check_sample_takes_every_rank_and_repeats_from_the_seed():
    spec = small(CELL, SMALL[CELL])
    owner = [q for q in range(4) for _ in range(150)] + [0] * 14  # 614 batches, 4 ranks
    owner_of = {r: owner for r in range(12)}
    for seed in range(2**31, 2**31 + 40):
        w = drive.Workload(spec["config"], spec["traffic"], seed)
        sample = ranks.check_sample(w, owner_of, 4)
        assert sample == ranks.check_sample(w, owner_of, 4)
        per = collections.Counter(owner[b] for bs in sample.values() for b in bs)
        assert sum(per.values()) == 8 and all(per[q] >= 2 for q in range(4))


Span = collections.namedtuple("Span", "id parent request name start_ns end_ns")


def test_rank_wait_is_from_the_last_readout_to_the_end_of_the_log():
    s = [Span(1, None, 1, "log", 0, 10_000_000_000), Span(2, 1, 1, "readout", 1, 7_000_000_000),
         Span(3, 1, 1, "readout", 1, 9_000_000_000), Span(4, None, 4, "log", 11, 15_000_000_000),
         Span(5, 4, 4, "readout", 12, 14_500_000_000), Span(6, None, 6, "forward", 20, 30)]
    assert spans.rank_wait(s, 0) == pytest.approx((1.0 + 0.5) / 2)
    assert spans.rank_wait(s, 5) == pytest.approx(0.5)
    assert spans.rank_wait(s, 100) is None


def test_the_breakdown_covers_every_card():
    traces = [{"ops": {"k1": 1.0, "k2": 0.5}, "idle_by_span": {"cg": 0.3, "plan": 0.1}},
              {"ops": {"k1": 2.0}, "idle_by_span": {"cg": 0.4}}]
    b = ranks.breakdown(traces)
    assert b["device_ops"] == [["k1", 3.0], ["k2", 0.5]]
    assert b["idle_gaps"] == [["rank 1: cg", 0.4], ["rank 0: cg", 0.3], ["rank 0: plan", 0.1]]
    json.dumps(b)
    assert np.isfinite([g[1] for g in b["idle_gaps"]]).all()
