"""The harness: its files found by name, BENCHMARK.json within its format,
the seeded request streams, and a run of each cell driven on the CPU at a
small size, unbroken (correct) and with the timed path broken underneath
(not correct)."""

import json
import math
import os
import re
import time

import numpy as np
import pytest

from h100_bench import drive, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def small(cell: str, count: int) -> dict:
    """The cell's spec on a small grid and the first ``count`` depths."""
    spec = run.cell_spec(BENCH, cell)
    grid = spec["config"]["grid"]
    if "np_" in grid:
        grid.update(nz=33, np_=9, nr=17, n_wall_cells=3, n_blend_cells=2)
    else:
        grid.update(nz=65, nr=17, n_wall_cells=4, n_blend_cells=2)
    depths = spec["traffic"]["depths"]
    (spec["config"]["depths"] if depths == "all" else depths)["count"] = count
    return spec


def test_benchmark_json_keeps_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:  # a per-layer metric only where its end-to-end one is
            assert m["moves"] in {x["name"] for x in run.cell_spec(BENCH, cell)["end_to_end"]}
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + [
            m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    spec = run.cell_spec(BENCH, cell)
    assert spec["traffic"]["entry"] in drive.ENTRIES
    assert set(spec["limits"]) and all(v > 0 for v in spec["limits"].values())
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"} and len(spec["end_to_end"]) >= 2
    assert spec["per_layer"]
    for m in spec["end_to_end"]:
        assert callable(run.reader("end_to_end", m["name"]))
    for m in spec["per_layer"]:
        assert callable(run.reader("layers", m["name"]))
        assert m["moves"] in {x["name"] for x in spec["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_request_streams_repeat_from_the_seed(cell):
    spec = run.cell_spec(BENCH, cell)
    seed = 2**31 + 12345
    a = drive.Workload(spec["config"], spec["traffic"], seed)
    b = drive.Workload(spec["config"], spec["traffic"], seed)
    c = drive.Workload(spec["config"], spec["traffic"], seed + 1)
    for i in (5, 0, -1, 3):  # any order
        np.testing.assert_array_equal(a.formation(i), b.formation(i))
        np.testing.assert_array_equal(a.params(i), b.params(i))
        assert not np.array_equal(a.params(i), c.params(i))
    assert a.check_sample(7, 20) == b.check_sample(7, 20)
    f = a.formation(2) / a.formation0
    fin = np.isfinite(f[:, 3])
    assert np.all((f[:, 4] >= 0.8) & (f[:, 4] <= 1.25))
    np.testing.assert_allclose(f[fin, 3], f[fin, 4])  # one factor per layer
    np.testing.assert_array_equal(np.isnan(a.formation(2)), np.isnan(a.formation0))
    np.testing.assert_array_equal(a.formation(2)[:, :3][~np.isnan(a.formation0[:, :3])],
                                  a.formation0[:, :3][~np.isnan(a.formation0[:, :3])])


SMALL = {"bm3_dip30.log_full": 8, "example01_2d.log_full": 12, "example01_2d.lm_step": 6}


def _run(cell, seconds=0.5, trace=False):
    return run.run(small(cell, SMALL[cell]), 2**31 + 7, seconds, trace, device="cpu",
                   t_start=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_of_each_cell_is_correct(cell):
    out = _run(cell, trace=True)
    assert out["correct"] and out["attempted"] >= 3 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] < c["limit"] for c in out["checks"].values())
    assert out["breakdown"] == {"device_ops": [], "idle_gaps": []}  # no card, no activity


def _stale(monkeypatch, cls):
    """A request that returns the previous request's answer."""
    orig, last = cls.request, {}

    def request(self, i):
        rec = orig(self, i)
        prev = last.get("rec")
        last["rec"] = rec
        return dict(prev, wall=0.0) if prev is not None else rec

    monkeypatch.setattr(cls, "request", request)


def _altered(monkeypatch, cls, key, factor):
    orig = cls.request

    def request(self, i):
        rec = orig(self, i)
        rec[key] = rec[key] * factor
        return rec

    monkeypatch.setattr(cls, "request", request)


def _half_batch(monkeypatch, cls, key):
    """Half of each answer left out, the mean of the rest in its place."""
    orig = cls.request

    def request(self, i):
        rec = orig(self, i)
        a = rec[key].copy()
        rows = a.shape[0] // 2
        a[rows:] = np.nanmean(a[:rows], axis=0)
        rec[key] = a
        return rec

    monkeypatch.setattr(cls, "request", request)


FAULTS = {
    "stale": lambda mp, cls: _stale(mp, cls),
    "altered_readout": lambda mp, cls: _altered(mp, cls, "values", 1.003),
    "half_batch": lambda mp, cls: _half_batch(mp, cls, "values"),
}
LM_FAULTS = {
    "altered_jacobian": lambda mp, cls: _altered(mp, cls, "jacobian", 1.03),
    "half_batch_jacobian": lambda mp, cls: _half_batch(mp, cls, "jacobian"),
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS] + [
    ("example01_2d.lm_step", f) for f in LM_FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    cls = drive.ENTRIES[run.cell_spec(BENCH, cell)["traffic"]["entry"]]
    {**FAULTS, **LM_FAULTS}[fault](monkeypatch, cls)
    out = _run(cell, seconds=1.0)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_fails_the_limits(cell):
    """The reference in TF32, put in the program's place, at a small size."""
    spec = small(cell, SMALL[cell])
    w = drive.Workload(spec["config"], spec["traffic"], 4242)
    entry = drive.ENTRIES[spec["traffic"]["entry"]](w, "cpu")
    entry.release()
    failed = False
    for r, batches in w.check_sample(1, entry.n_batches).items():
        ref = entry.reference(r, batches, "float64", "cpu")
        low = entry.compare(entry.as_record(entry.reference(r, batches, "tf32", "cpu")), ref)
        failed |= any(v > spec["limits"][k] for k, v in low.items())
    assert failed


def test_log_tail_is_nearest_rank():
    read = run.reader("end_to_end", "log_s_p95.3d")
    recs = [{"wall": float(x)} for x in range(1, 21)]
    assert read({"records": recs}) == 19.0
    assert read({"records": recs[:1]}) == 1.0
    assert math.isclose(run.reader("end_to_end", "readouts_per_s.3d")(
        {"records": [{"work": 100, "failed": False}] * 3, "window_s": 6.0}), 50.0)
