"""The harness: its files found by name, BENCHMARK.json within its format,
the seeded request streams, and a run of each cell driven on the CPU at a
small size, unbroken (correct) and with the timed path broken underneath
(not correct). A cell of several ranks runs as two ranks over gloo, rank 0
in a process of its own (:func:`run_ranks`)."""

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from h100_bench import drive, ranks, run

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
    if "ranks" in spec["traffic"]:
        spec["traffic"]["ranks"] = 2
    return spec


# Rank 0 of a CPU run of a cell of several ranks, with a fault of FAULTS
# planted in it where one is named, or with "no_exchange" its gather of the
# readouts left out (argv[1]: a JSON object of run_ranks's arguments).
RANK0 = """
import json, sys, time
t_start = time.perf_counter()
sys.path.insert(0, "h100_bench/tests")
import numpy as np
import pytest
from test_h100_bench_harness import FAULTS, small
from h100_bench import drive, ranks
a = json.loads(sys.argv[1])
if a["fault"] == "no_exchange":
    from remo3d_tpu_torch.parallel import distributed
    distributed.gather_result = lambda x, owned=None: np.array(x, dtype=float)
elif a["fault"]:
    FAULTS[a["fault"]](pytest.MonkeyPatch(), drive.SimulateLogs)
ranks.STALL_S = a["stall_s"]
out = ranks.run(small(a["cell"], a["count"]), a["seed"], a["seconds"], a["trace"],
                device="cpu", t_start=t_start, child=a["child"])
print(json.dumps(out))
"""
# Rank 1 with a planted fault (argv[1]): its share of each log "altered"
# (x 1.003) or "stale" (the previous log's) before the gather, or its gather
# left out ("no_exchange"); or, at request 1, it "raises", is "killed" or
# "hangs".
RANK1 = """
import os, signal, sys, time
import numpy as np
fault = sys.argv[1]
if os.environ["RANK"] == "1":
    from h100_bench import drive
    from remo3d_tpu_torch.parallel import distributed
    gather, request, last = distributed.gather_result, drive.SimulateLogs.request, {}

    def gather_result(x, owned=None):
        x = np.array(x, dtype=float)
        prev, last["x"] = last.get("x"), x.copy()
        if fault == "no_exchange":
            return x
        if fault == "altered":
            x[owned] *= 1.003
        elif fault == "stale" and prev is not None:
            x[owned] = prev[owned]
        return gather(x, owned)

    def faulty(self, i):
        if i == 1 and fault == "raises":
            raise RuntimeError("a planted fault")
        if i == 1 and fault == "killed":
            os.kill(os.getpid(), signal.SIGKILL)
        if i == 1 and fault == "hangs":
            time.sleep(3600)
        return request(self, i)

    distributed.gather_result = gather_result
    drive.SimulateLogs.request = faulty
from h100_bench import ranks
ranks.main()
"""


def run_ranks(cell, count, seconds=0.5, trace=False, fault=None, child_fault=None,
              stall_s=120.0, seed=2**31 + 7, timeout=300):
    """A CPU run of a cell of several ranks, rank 0 in a process of its own,
    one thread to a process as in a run (a step may take ``stall_s`` on a
    CPU that other tests share): (its result line or None, its standard
    error, its exit code, its seconds, the children's pids)."""
    child = ([sys.executable, "-c", RANK1, child_fault] if child_fault
             else list(ranks.CHILD))
    args = {"cell": cell, "count": count, "seconds": seconds, "trace": trace, "fault": fault,
            "stall_s": stall_s, "seed": seed, "child": child}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RANK0, json.dumps(args)], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, **{var: "1" for var in run.THREAD_VARS}))
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if lines else None
    pids = [int(p) for p in re.findall(r"h100_bench: rank \d+ pid (\d+)", proc.stderr)]
    return out, proc.stderr, proc.returncode, seconds, pids


def gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


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
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    # At most a quarter of the cells (rounded down) on four chips; one always may.
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
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


SMALL = {"bm3_dip30.log_full": 8, "example01_2d.log_full": 12, "example01_2d.lm_step": 6,
         "example01_2d.ranks4": 12}


def _run(cell, seconds=0.5, trace=False, fault=None):
    """A CPU run of the cell at its small size; a cell of several ranks runs
    through :func:`run_ranks`, with ``fault`` (a key of FAULTS) in rank 0."""
    if "ranks" in run.cell_spec(BENCH, cell)["traffic"]:
        out, err, code, _, _ = run_ranks(cell, SMALL[cell], seconds, trace, fault)
        assert code == 0 and out is not None, err[-3000:]
        return out
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
    spec = run.cell_spec(BENCH, cell)
    if "ranks" in spec["traffic"]:  # planted in rank 0, whose record is the request's
        out = _run(cell, seconds=1.0, fault=fault)
    else:
        cls = drive.ENTRIES[spec["traffic"]["entry"]]
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
    # The four-card cell's tail, per layer: the traced logs left out.
    untraced = run.reader("layers", "log_wall_p95.ranks4")
    assert untraced({"records": recs, "traced": recs[1:3]}) == 20.0
    assert untraced({"records": recs, "traced": recs[18:20]}) == 18.0
    assert math.isclose(run.reader("end_to_end", "readouts_per_s.3d")(
        {"records": [{"work": 100, "failed": False}] * 3, "window_s": 6.0}), 50.0)
