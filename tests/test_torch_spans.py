# -*- coding: utf-8 -*-
"""The port's spans (remo3d_tpu_torch/utils/timers.py): how they nest and
carry their request, across the executor's read-ahead thread too; that
nothing is kept without a profiler while the phases still add up; the
buffer's bound; their clock against the profiler's annotations; the span
trees of a small 2D log and of a DifferentiableLog forward and Jacobian; and
the ``profile_dir`` trace. CPU only, small sizes."""

import collections
import glob
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from remo3d_tpu_torch import DifferentiableLog, Model
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D
from remo3d_tpu_torch.utils import timers
from remo3d_tpu_torch.utils.timers import (
    LABEL_PREFIX,
    PhaseTimers,
    entered,
    request_context,
    span,
    span_snapshot,
)

torch.set_num_threads(2)

FORMATION = np.array([
    [-100.0, -1.0, np.nan, np.nan, 10.0],
    [-1.0, 1.0, 0.3, 4.0, 100.0],
    [1.0, 100.0, np.nan, np.nan, 10.0],
])
BOREHOLE = np.array([[-100.0, 0.1, 1.0], [100.0, 0.1, 1.0]])
TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]
GRID = GridSpec2D(nz=65, nr=17, n_wall_cells=6, n_blend_cells=3)
DEPTHS = np.arange(-0.6, 0.61, 0.2)  # 7 depths: 5 chunks of at most 3 batches


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def new_spans(before):
    """The spans kept since the snapshot ``before``."""
    last = max((s.id for s in before.spans), default=0)
    return [s for s in span_snapshot().spans if s.id > last]


def children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def names(spans):
    return collections.Counter(s.name for s in spans)


def test_spans_nest_and_carry_their_request_to_another_thread():
    before = span_snapshot()
    with cpu_profile():
        with span("root"):
            with span("child"):
                with span("grandchild") as attrs:
                    attrs["figure"] = 3
            context = request_context()

            def work():
                with entered(context), span("ahead"):
                    pass

            t = threading.Thread(target=work)
            t.start()
            t.join(30)
            assert not t.is_alive()
        with span("other_root"):
            with span("its_child"):
                pass
    got = {s.name: s for s in new_spans(before)}
    assert set(got) == {"root", "child", "grandchild", "ahead", "other_root", "its_child"}
    root, other = got["root"], got["other_root"]
    assert root.parent is None and other.parent is None and root.request == root.id
    assert got["child"].parent == root.id and got["grandchild"].parent == got["child"].id
    assert got["ahead"].parent == root.id and got["ahead"].thread != root.thread
    assert {got[n].request for n in ("child", "grandchild", "ahead")} == {root.id}
    assert got["its_child"].parent == other.id and got["its_child"].request == other.id
    assert got["grandchild"].attrs == {"figure": 3}
    for s in got.values():
        assert s.start_ns <= s.end_ns
    assert root.start_ns <= got["child"].start_ns <= got["grandchild"].start_ns
    assert got["grandchild"].end_ns <= got["child"].end_ns <= root.end_ns


def test_nothing_is_kept_without_a_profiler_and_the_phases_still_add_up():
    before = span_snapshot()
    t = PhaseTimers()
    with t.phase("outer"):
        with span("inner"):  # a phase of the enclosing span's timers
            time.sleep(0.002)
        with t.phase("second"):
            pass
    with t.phase("outer"):
        pass
    after = span_snapshot()
    assert len(after.spans) == len(before.spans) and after.dropped == before.dropped
    assert [s.id for s in after.spans[-3:]] == [s.id for s in before.spans[-3:]]
    assert dict(t.counts) == {"outer": 2, "inner": 1, "second": 1}
    assert t.seconds["outer"] >= t.seconds["inner"] + t.seconds["second"]
    assert t.seconds["inner"] >= 0.002
    # The report's total leaves out the phases nested in "outer".
    assert f"total {t.seconds['outer']:.3f}s" in t.report()


def test_the_buffer_drops_its_oldest_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(timers, "_buffer", collections.deque(maxlen=3))
    dropped = span_snapshot().dropped
    with cpu_profile():
        for k in range(5):
            with span(f"bounded{k}"):
                pass
    snap = span_snapshot()
    assert [s.name for s in snap.spans] == ["bounded2", "bounded3", "bounded4"]
    assert snap.dropped == dropped + 2


def test_spans_lie_on_the_profilers_clock():
    before = span_snapshot()
    with cpu_profile() as prof:
        for k in range(3):
            with span(f"clock{k}"):
                time.sleep(0.005 * (k + 1))
    spans = {s.name: s for s in new_spans(before)}
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    assert set(spans) == {"clock0", "clock1", "clock2"}
    for name, s in spans.items():
        e = ranges[LABEL_PREFIX + name]
        assert abs(e.start_ns() - s.start_ns) <= 1_000_000, (name, e.start_ns(), s.start_ns)
        end = e.start_ns() + e.duration_ns()
        assert abs(end - s.end_ns) <= 1_000_000, (name, end, s.end_ns)


def test_a_2d_log_gives_the_span_tree():
    """Roots "set_model_parameters" and "log"; under "log" the planning, the
    executor's set-up and its phases; under each "solve" the assembly (with
    the direct factor, the CPU's default), the CG loop with its figures and
    the wait for the results; on the read-ahead thread "mesh_ahead" and
    "stack_ahead" of the same request."""
    m = Model(TOOLS)
    before = span_snapshot()
    with cpu_profile():
        m.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius")
        m.simulate_logs(DEPTHS, device="cpu", batch_size=1, verbose=False, grid_spec=GRID,
                        executor_overrides={"chunk_size": 3})
    spans = new_spans(before)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["set_model_parameters", "log"]
    log = roots[1]
    assert not children(spans, roots[0])
    assert all(s.request == log.id for s in spans if s is not roots[0])
    n_chunks = len(m.last_report["chunks"])
    assert n_chunks == 5
    caller = [s for s in spans if s.thread == log.thread]
    under_log = names(children(caller, log))
    assert under_log["plan"] == under_log["prepare"] == 1
    assert under_log["solve"] == under_log["stage"] == under_log["readout"] == n_chunks
    assert under_log["mesh"] >= 1 and under_log["stack"] == 1
    assert under_log["pipeline_wait"] == n_chunks - 1
    assert set(under_log) == {"plan", "prepare", "mesh", "stack", "stage", "solve", "readout",
                              "pipeline_wait"}
    for solve, chunk in zip([s for s in caller if s.name == "solve"], m.last_report["chunks"]):
        kids = children(spans, solve)
        assert [s.name for s in kids] == ["assemble", "cg", "results_wait"]
        assert names(children(spans, kids[0])) == {"factor": 1}
        assert kids[1].attrs == {"iterations": chunk["iterations"], "replays": 0,
                                 "capture_seconds": 0.0}
    ahead = [s for s in spans if s.thread != log.thread]
    assert ahead and set(names(ahead)) == {"mesh_ahead", "stack_ahead"}
    assert all(s.parent == log.id for s in ahead)
    phases = m.last_report["phases"]
    assert {"plan", "prepare", "assemble", "factor", "cg", "results_wait"} <= set(phases)
    assert m._executor.timers.counts["cg"] == n_chunks


def test_a_differentiable_forward_and_jacobian_give_the_span_tree():
    """Roots "forward" and "jacobian"; per chunk "assembly", "factor" and
    "solve" (with "tangent" in the Jacobian) and "report_sync" last; the
    chunk reports carry each span's host seconds."""
    m = Model(TOOLS)
    m.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius")
    dlog = DifferentiableLog(m, np.array([-0.2, 0.2]), grid_spec=GRID, chunk_size=8,
                             device="cpu")
    before = span_snapshot()
    with cpu_profile():
        dlog.forward(dlog.params0)
        forward = dlog.last_report["chunks"]
        dlog.jacobian(dlog.params0)
        jacobian = dlog.last_report["chunks"]
    spans = new_spans(before)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["forward", "jacobian"]
    for root, chunks, extra in ((roots[0], forward, []), (roots[1], jacobian, ["tangent"])):
        kids = children(spans, root)
        n = len(chunks)
        assert [s.name for s in kids] == ["assembly", "factor", "solve"] * n + ["report_sync"]
        solves = [s for s in kids if s.name == "solve"]
        assert [s.name for x in solves for s in children(spans, x)] == extra * n
        for c in chunks:
            assert set(c["host_s"]) == {"assembly", "factor", "solve", *extra}
            assert all(v > 0 for v in c["host_s"].values())
            assert {"assembly_s", "factor_s", "solve_s"} <= set(c)


def test_the_profile_dir_trace_holds_the_spans(tmp_path):
    m = Model(TOOLS)
    m.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius")
    m.simulate_logs(DEPTHS[:2], device="cpu", batch_size=1, verbose=False, grid_spec=GRID,
                    profile_dir=str(tmp_path))
    (path,) = glob.glob(str(tmp_path / "*.json"))
    text = open(path).read()
    for label in ("solve_chunk", "assemble", "cg", "results_wait", "readout"):
        assert LABEL_PREFIX + label in text, label


@pytest.mark.parametrize("window", [1, 3])
def test_the_phases_of_a_log_are_those_of_its_spans(window):
    """A log's phase seconds and counts, with and without the read-ahead,
    are its recorded spans' durations and counts (the caller's and the
    read-ahead thread's): one pair of clock reads times both."""
    m = Model(TOOLS)
    m.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius")
    before = span_snapshot()
    with cpu_profile():
        m.simulate_logs(DEPTHS, device="cpu", batch_size=1, verbose=False, grid_spec=GRID,
                        executor_overrides={"chunk_size": 3, "pipeline_window": window})
    spans = [s for s in new_spans(before) if s.name != "log"]
    counts = names(spans)
    phases = m.last_report["phases"]
    assert set(counts) == set(phases)
    assert dict(m._executor.timers.counts) == {
        k: v for k, v in counts.items() if k not in ("plan", "prepare")}
    for name, seconds in phases.items():
        recorded = sum(s.end_ns - s.start_ns for s in spans if s.name == name) / 1e9
        assert recorded == pytest.approx(seconds, rel=1e-9, abs=1e-9), name


THIN_FORMATION = np.array([
    [-100.0, -1.0, np.nan, np.nan, 10.0],
    [-1.0, 1.0, 0.2, 5.0, 100.0],  # 0.1 m of annulus past the wall: thin
    [1.0, 100.0, np.nan, np.nan, 10.0],
])


@pytest.mark.parametrize("case,builder", [("2D", "native"), ("2D device meshing", "device"),
                                          ("3D thin annulus", "native")])
def test_the_grids_of_a_log_are_counted(case, builder):
    """``last_report["grids"]`` counts one grid per batch of the plan, all by
    ``last_report["mesher"]``, one "mesh" / "mesh_ahead" span each, and the
    chunks' rows count their own batches' grids."""
    from remo3d_tpu_torch.meshing.grid3d import GridSpec3D
    from remo3d_tpu_torch.planner import plan_tasks

    m = Model(TOOLS)
    is3d = case.startswith("3D")
    m.set_model_parameters(THIN_FORMATION if is3d else FORMATION, BOREHOLE,
                           borehole_geometry_type="radius", dip=60 if is3d else 0)
    depths = DEPTHS[:4] if is3d else DEPTHS
    overrides = {"chunk_size_3d" if is3d else "chunk_size": 2,
                 "device_meshing": case.endswith("device meshing")}
    grid = ({"grid_spec3d": GridSpec3D(nz=33, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2,
                                       fz_h_radial=0.025), "batch_size": 2}
            if is3d else {"grid_spec": GRID, "batch_size": 1})
    before = span_snapshot()
    with cpu_profile():
        m.simulate_logs(depths, device="cpu", verbose=False, executor_overrides=overrides,
                        **grid)
    report = m.last_report
    n_batches = len(plan_tasks(m.tools, m.sec, depths, grid["batch_size"])[1])
    assert report["mesher"] == builder and report["grids"] == n_batches
    assert [c["grids"] for c in report["chunks"]] == [c["batches"] for c in report["chunks"]]
    meshes = [s for s in new_spans(before) if s.name in ("mesh", "mesh_ahead")]
    assert len(meshes) == n_batches
