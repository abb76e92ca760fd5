# -*- coding: utf-8 -*-
"""Benchmark model 2 at a 60 degree dip, the benchmark's configuration
``bm2_dip60`` (h100_bench/configs/bm2_dip60.json), on the CPU: the grid that
``Model`` picks by default for its tables is the configuration's; a shrunk
copy of its log through ``Model.simulate_logs`` matches the benchmark's plain
float64 reference (h100_bench/reference); and the harness finds the two cells
that this configuration and Example_01's 101-depth log add, with their
metrics, limits and traffic, and runs each at a small size: correct as it
is, not correct with a stale or altered answer, and the TF32 control fails
its limit.

Grids here keep the 3D planes under 128 nodes (np_ * nr): this CPU's MKL
hangs in ``linalg.solve`` on larger blocks once a thread count was set."""

import json
import os
import time

import numpy as np
import pytest
import torch

from h100_bench import drive, grids, run
from h100_bench.reference import log as ref_log
from remo3d_tpu_torch import Model
from remo3d_tpu_torch import model as tmodel
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CONFIG = run.load_json(os.path.join(ROOT, "h100_bench", "configs", "bm2_dip60.json"))
SEED = 2**31 + 1919
NEW_CELLS = {
    "bm2_dip60.log_full": ("log_full", "readouts_per_s.3d", {
        "mesh_s_per_grid.dip60", "mesh_s_per_log.3d", "stage_s_per_log.3d",
        "cg_iters_per_chunk.3d", "k2_roofline", "k3_roofline.3d", "device_idle.3d",
        "idle_prep_s_per_log.3d", "idle_cg_s_per_log.3d"}),
    "example01_2d.log101": ("log101", "readouts_per_s.2d", {
        "mesh_s_per_grid.log101", "log_wall_p95.log101", "mesh_s_per_log.2d",
        "stage_s_per_log.2d", "cg_iters_per_chunk.2d", "k3_roofline.2d", "device_idle.2d",
        "idle_prep_s_per_log.2d"}),
}
SMALL_3D = dict(nz=33, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2)


def model(formation):
    m = Model(CONFIG["tools"])
    m.set_model_parameters(formation, drive.table(CONFIG["borehole"]),
                           borehole_geometry_type="radius", dip=CONFIG["dip"])
    return m


def test_the_default_grid_is_the_configurations():
    """The cell measures what a user of these tables gets with no grid
    given: the high-dip grid with the thin-annulus anchors of the 0.2 m
    invasion."""
    m = model(drive.table(CONFIG["formation"]))
    spec, notices = tmodel._resolve_spec3d(m.dip_deg, None, None, m.formation_model,
                                           m.borehole_model)
    assert spec == GridSpec3D(**CONFIG["grid"])
    assert (spec.nz, spec.np_, spec.nr) == (257, 25, 65) and spec.fz_h_radial is not None
    assert len(notices) == 2


@pytest.mark.parametrize("request_index", [0, 1])
def test_a_shrunk_log_matches_the_reference(request_index):
    """Four depths of the configuration on a 33x5x17 grid that keeps
    ``fz_h_radial``, its resistivities scaled by the traffic's factors drawn
    from a seed, through ``Model.simulate_logs`` in float64 with the card's
    solver (ADI-preconditioned CG, native meshing), against the reference's
    float64 direct solve of the same system. Tolerance 1e-9 relative: CG
    stops at a relative residual of 1e-10 and the readouts measured 6.3e-12
    apart; a float32 solve is 3e-5 apart and fails it."""
    config = dict(CONFIG, grid=dict(CONFIG["grid"], **SMALL_3D),
                  depths=dict(CONFIG["depths"], start=9.0, count=4))
    w = drive.Workload(config, run.load_json(os.path.join(ROOT, "h100_bench", "traffic",
                                                          "log_full.json")), SEED)
    m = model(w.formation(request_index))
    m.simulate_logs(w.depths, device="cpu", dtype="float64", tol=1e-10, verbose=False,
                    grid_spec3d=GridSpec3D(**config["grid"]),
                    executor_overrides={"precond3d": "adi"})
    report = m.last_report
    assert report["mesher"] == "native" and report["n_failed_solves"] == 0
    plan = ref_log.Plan(w.case)
    assert report["grids"] == len(plan.tasks)
    ref = ref_log.readouts(plan, range(len(plan.tasks)), formation=w.formation(request_index))
    values = np.stack([m.logs[t][:, 1] for t in w.tools], axis=1)
    assert len(ref) == values.size
    for k, v in ref.items():
        assert values[k] == pytest.approx(v, rel=1e-9), k


@pytest.mark.parametrize("cell", sorted(NEW_CELLS))
def test_the_harness_resolves_the_new_cells(cell):
    traffic, rate, per_layer = NEW_CELLS[cell]
    spec = run.cell_spec(BENCH, cell)
    assert spec["cell"]["traffic"] == traffic and spec["cell"]["chips"] == 1
    assert spec["limits"] == {"readout_gap": 2e-3}
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s", rate}
    # No tail end to end: too few logs (bm2) or too noisy a p95 (log101).
    assert not {m["name"] for m in spec["end_to_end"]} & {"log_s_p95.3d", "log_s_p95.2d"}
    assert {m["name"] for m in spec["per_layer"]} == per_layer
    for m in spec["end_to_end"]:
        assert callable(run.reader("end_to_end", m["name"]))
    for m in spec["per_layer"]:
        assert callable(run.reader("layers", m["name"])) and m["moves"] == rate
    w = drive.Workload(spec["config"], spec["traffic"], SEED)
    n_batches = len(ref_log.Plan(w.case).tasks)
    assert n_batches == (16 if cell.startswith("bm2") else 74)
    assert len(w.depths) * len(w.tools) == (80 if cell.startswith("bm2") else 606)


def test_mesh_s_per_grid_reads_the_grid_counts():
    """Mesh seconds of the traced logs over the grids their chunks count;
    None from a program that counts none."""
    rec = {"phases": {"mesh": 0.3, "mesh_ahead": 0.5, "solve": 9.0},
           "chunks": [{"grids": 8}, {"grids": 8}]}
    assert grids.mesh_s_per_grid({"traced": [rec, rec]}) == pytest.approx(0.05)
    old = dict(rec, chunks=[{"iterations": 3}])
    assert grids.mesh_s_per_grid({"traced": [old, old]}) is None
    assert grids.mesh_s_per_grid({"traced": []}) is None


def small(cell: str) -> dict:
    spec = run.cell_spec(BENCH, cell)
    grid = spec["config"]["grid"]
    if "np_" in grid:
        grid.update(SMALL_3D)
        spec["config"]["depths"]["count"] = 8
    else:
        grid.update(nz=65, nr=17, n_wall_cells=4, n_blend_cells=2)
        spec["traffic"]["depths"]["count"] = 12
    return spec


@pytest.mark.parametrize("cell", sorted(NEW_CELLS))
def test_a_cpu_run_of_a_new_cell_is_correct(cell):
    out = run.run(small(cell), SEED, 0.5, True, device="cpu", t_start=time.perf_counter())
    assert out["correct"] and out["attempted"] >= 3 and out["failed"] == 0
    assert all(c["value"] < c["limit"] for c in out["checks"].values())
    (mesh,) = [n for n in NEW_CELLS[cell][2] if n.startswith("mesh_s_per_grid")]
    assert out["metrics"][mesh]["value"] > 0  # no card: no device metric


def _stale(monkeypatch):
    """Each request returns the previous request's answer."""
    orig, last = drive.SimulateLogs.request, {}

    def request(self, i):
        rec = orig(self, i)
        prev, last["rec"] = last.get("rec"), rec
        return dict(prev, wall=0.0) if prev is not None else rec

    monkeypatch.setattr(drive.SimulateLogs, "request", request)


def _altered(monkeypatch):
    """Each readout off by 0.3%."""
    orig = drive.SimulateLogs.request

    def request(self, i):
        rec = orig(self, i)
        rec["values"] = rec["values"] * 1.003
        return rec

    monkeypatch.setattr(drive.SimulateLogs, "request", request)


@pytest.mark.parametrize("fault", [_stale, _altered], ids=["stale", "altered_readout"])
@pytest.mark.parametrize("cell", sorted(NEW_CELLS))
def test_a_broken_timed_path_of_a_new_cell_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run.run(small(cell), SEED, 1.0, False, device="cpu", t_start=time.perf_counter())
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(NEW_CELLS))
def test_the_tf32_control_fails_the_limit_of_a_new_cell(cell):
    """The reference in TF32 in the program's place, at the small size."""
    spec = small(cell)
    w = drive.Workload(spec["config"], spec["traffic"], SEED)
    entry = drive.SimulateLogs(w, "cpu")
    entry.release()
    gaps = []
    for r, batches in w.check_sample(1, entry.n_batches).items():
        ref = entry.reference(r, batches, "float64", "cpu")
        low = entry.as_record(entry.reference(r, batches, "tf32", "cpu"))
        gaps.append(entry.compare(low, ref)["readout_gap"])
    assert max(gaps) > spec["limits"]["readout_gap"]
