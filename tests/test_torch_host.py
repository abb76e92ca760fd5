# -*- coding: utf-8 -*-
"""The port's numpy host layer (tools, io, planner, carve, grid2d, grid3d) is a
copy of the JAX package's: same inputs, bit-equal outputs."""

import dataclasses
from unittest import mock

import numpy as np
import pytest

import remo3d_tpu.io as jio
import remo3d_tpu.meshing.carve as jcarve
import remo3d_tpu.meshing.grid2d as jgrid
import remo3d_tpu.meshing.grid3d as jgrid3
import remo3d_tpu.planner as jplanner
import remo3d_tpu.tools as jtools
import remo3d_tpu_torch.io as tio
import remo3d_tpu_torch.meshing.carve as tcarve
import remo3d_tpu_torch.meshing.grid2d as tgrid
import remo3d_tpu_torch.meshing.grid3d as tgrid3
import remo3d_tpu_torch.planner as tplanner
import remo3d_tpu_torch.tools as ttools
from remo3d_tpu_torch.parallel.runtime import Executor, ExecutorConfig
from remo3d_tpu_torch.validation.models import BM2_BOREHOLE, BM2_FORMATION, EXAMPLE01_TOOLS

TOOL_NAMES = ["B5.7A0.4M", "B4.48A1.62M", "M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A",
              "M4.0A0.5B", "A1.0M0.2N", "A8.0M1.0N"]

FORMATIONS = {
    "invaded_layers": (
        np.array([
            [-100.0, -1.0, np.nan, np.nan, 10.0],
            [-1.0, 1.0, 0.3, 4.0, 20.0],
            [1.0, 100.0, np.nan, np.nan, 8.0],
        ]),
        np.array([[-100.0, 0.12, 1.1], [100.0, 0.12, 1.1]]),
    ),
    "bm2_like_caliper": (
        np.array([
            [-100.0, 5.0, np.nan, np.nan, 10.0],
            [5.0, 15.0, 0.2, 5.0, 100.0],
            [15.0, 25.0, np.nan, np.nan, 10.0],
            [25.0, 35.0, 0.35, 5.0, 100.0],
            [35.0, 200.0, np.nan, np.nan, 10.0],
        ]),
        np.array([[-100.0, 0.1, 1.0], [4.0, 0.1, 1.0], [6.0, 0.15, 0.8],
                  [8.0, 0.1, 1.2], [200.0, 0.1, 1.2]]),
    ),
}


def _assert_same(a, b, path="root"):
    """Recursive exact equality of dataclasses, lists, arrays and scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), (path, a, b)


@pytest.mark.parametrize("force_sec", [True, False])
def test_tools_bit_equal(force_sec):
    jt, jsec = jtools.parse_tools(TOOL_NAMES, force_sec)
    tt, tsec = ttools.parse_tools(TOOL_NAMES, force_sec)
    assert jsec == tsec and list(jt) == list(tt)
    for name in TOOL_NAMES:
        _assert_same(jt[name], tt[name], name)
        np.testing.assert_array_equal(jt[name].as_array, tt[name].as_array)


@pytest.mark.parametrize("force_sec", [True, False])
def test_planner_bit_equal(force_sec):
    depths = np.arange(0.0, 3.01, 0.1)
    jt, jsec = jtools.parse_tools(TOOL_NAMES[:5], force_sec)
    tt, tsec = ttools.parse_tools(TOOL_NAMES[:5], force_sec)
    jd, jtasks = jplanner.plan_tasks(jt, jsec, depths, 5)
    td, ttasks = tplanner.plan_tasks(tt, tsec, depths, 5)
    np.testing.assert_array_equal(jd, td)
    _assert_same(jtasks, ttasks, "tasks")


@pytest.mark.parametrize("name", sorted(FORMATIONS))
def test_io_carve_grid2d_bit_equal(name):
    formation, borehole = FORMATIONS[name]
    jf = jio.set_formation_parameters(formation)
    tf = tio.set_formation_parameters(formation)
    jb = jio.set_borehole_parameters(borehole, "radius")
    tb = tio.set_borehole_parameters(borehole, "radius")
    np.testing.assert_array_equal(jf, tf)
    np.testing.assert_array_equal(jb, tb)

    jspec = jgrid.GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2)
    tspec = tgrid.GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2)
    electrodes = np.array([-2.5, -0.5, 0.0, 2.0])
    sources = np.array([0.0])
    for center in (0.0, 5.1, 14.9):
        jlm = jcarve.carve_local_model(jf, jb[:, :2], 1.1, center, 50.0, active_geometry_window=0.999)
        tlm = tcarve.carve_local_model(tf, tb[:, :2], 1.1, center, 50.0, active_geometry_window=0.999)
        _assert_same(jlm, tlm, f"{name}@{center}.local_model")
        jp = jgrid.build_profiles_2d(jspec, 50.0, jlm, electrodes, sources)
        tp = tgrid.build_profiles_2d(tspec, 50.0, tlm, electrodes, sources)
        _assert_same(list(jp), list(tp), f"{name}@{center}.profiles")
        jg = jgrid.build_grid2d(jspec, 50.0, jlm, electrodes, sources)
        tg = tgrid.build_grid2d(tspec, 50.0, tlm, electrodes, sources)
        for field in ("z_axis", "coords", "sigma_cells", "free_mask", "region_layer",
                      "region_invaded"):
            _assert_same(getattr(jg, field), getattr(tg, field), f"{name}@{center}.{field}")
        assert jg.axis_node_index(2.0) == tg.axis_node_index(2.0)
        jl = jgrid.build_grid2d_light(jspec, 50.0, jlm, electrodes, sources)
        tl = tgrid.build_grid2d_light(tspec, 50.0, tlm, electrodes, sources)
        assert jl.content_bytes() == tl.content_bytes()
        assert jl.grid_shape == tl.grid_shape


@pytest.mark.parametrize("dip_deg", [30, 60])
@pytest.mark.parametrize("preset", ["default", "fast"])
def test_grid3d_bit_equal(preset, dip_deg):
    """build_grid3d (coords, conductivities, free mask and the region outputs)
    over an invaded formation with a varying caliper, at the default and fast
    specs; the presets and the threshold constant agree too."""
    formation, borehole = FORMATIONS["bm2_like_caliper"]
    tf = tio.set_formation_parameters(formation)
    tb = tio.add_points_to_borehole(tio.set_borehole_parameters(borehole, "radius"))
    jspec = jgrid3.GridSpec3D() if preset == "default" else jgrid3.GridSpec3D.fast()
    tspec = tgrid3.GridSpec3D() if preset == "default" else tgrid3.GridSpec3D.fast()
    assert dataclasses.astuple(jspec) == dataclasses.astuple(tspec)
    for name in ("accurate", "high_dip"):
        assert dataclasses.astuple(getattr(jgrid3.GridSpec3D, name)()) == dataclasses.astuple(
            getattr(tgrid3.GridSpec3D, name)())
    assert jgrid3.THIN_ANNULUS_MIN_CELLS == tgrid3.THIN_ANNULUS_MIN_CELLS
    dip = np.deg2rad(dip_deg)
    electrodes = np.array([4.0, 5.0, 5.5, 7.0])
    sources = np.array([5.0])
    lm = tcarve.carve_local_model(tf, tb[:, :2], 1.0, 5.2, 50.0, dip_rad=dip,
                                  active_geometry_window=0.99)
    jg = jgrid3.build_grid3d(jspec, 50.0, lm, dip, electrodes, sources, with_regions=True)
    tg = tgrid3.build_grid3d(tspec, 50.0, lm, dip, electrodes, sources, with_regions=True)
    for field in ("z_axis", "coords", "sigma_cells", "free_mask", "region_uz_weights",
                  "region_fz_layer", "region_fixed"):
        _assert_same(getattr(jg, field), getattr(tg, field), f"{preset}@{dip_deg}.{field}")
    assert jg.axis_node_index(5.5) == tg.axis_node_index(5.5)


def _example01_plan():
    """Example_01's 2D log as ``Model.simulate_logs`` plans it: six tools
    (single electrode configuration), 251 depths every 0.1 m, batches of 5,
    over the BM2-like invaded formation."""
    tools, sec = ttools.parse_tools(EXAMPLE01_TOOLS, True)
    depths = 0.1 * np.arange(251)
    formation = tio.set_formation_parameters(BM2_FORMATION)
    borehole = tio.set_borehole_parameters(BM2_BOREHOLE, "radius")
    sim_depths, tasks = tplanner.plan_tasks(tools, sec, depths, 5)
    mud = np.interp(sim_depths, borehole[:, 0], borehole[:, 2])
    return tasks, formation, borehole[:, :2], mud


def _example01_batch_calls():
    """The arguments of the two ``_graded_1d`` calls (z lines, far radial
    stations) of the Example_01 batch centred nearest 10 m, inside an invaded bed."""
    tasks, formation, borehole, mud = _example01_plan()
    b = int(np.argmin([abs(t.center_depth - 10.0) for t in tasks]))
    t = tasks[b]
    lm = tcarve.carve_local_model(formation, borehole, float(mud[t.batch_index]),
                                  t.center_depth, 50.0, active_geometry_window=0.999)
    sources = np.unique(np.concatenate([s.source_positions for s in t.solves]))
    calls = []
    real = tgrid._graded_1d

    def record(*args):
        calls.append(args)
        return real(*args)

    with mock.patch.object(tgrid, "_graded_1d", record):
        tgrid.build_profiles_2d(tgrid.GridSpec2D(), 50.0, lm, t.electrode_positions, sources)
    assert len(calls) == 2 and calls[1][3][1][0].size  # the far call anchors invasion
    return calls


GRADED_CASES = {
    "many_centers": lambda: [(-50.0, 50.0, 761, [
        (np.random.default_rng(17).uniform(-8.0, 8.0, 30), 0.02, 0.5),
        (np.array([0.0]), 0.01, 0.6)], 6.0)],
    "duplicate_centers": lambda: [(-50.0, 50.0, 97, [
        (np.array([-1.0, 0.5, 0.5, 0.5, 2.0, -1.0]), 0.02, 0.5)], 6.0)],
    "centers_outside": lambda: [(-5.0, 5.0, 65, [
        (np.array([-7.5, -5.0, 0.3, 5.0, 9.0]), 0.05, 1.0), (np.array([12.0]), 0.01, 0.6)], 1.2)],
    "term_without_centers": lambda: [(-50.0, 50.0, 97, [
        (np.array([0.0]), 0.01, 0.6), (np.array([]), 0.05, 1.0)], 6.0)],
    "single_center": lambda: [(0.13, 50.0, 149, [(np.array([0.13]), 0.008, 0.12)], 6.0)],
    "anchors_3d_two_h_min": lambda: [(0.13, 50.0, 53, [
        (np.array([0.13]), 0.008, 0.12), (np.array([0.11, 0.125]), 0.002, 0.12),
        (np.array([0.35, 0.5]), 0.008, 0.12)], 6.0)],
    "example01_batch": _example01_batch_calls,
}


@pytest.mark.parametrize("case", sorted(GRADED_CASES))
def test_graded_1d_bit_equal(case):
    """The port's ``_graded_1d`` (offsets cached per h_min, nearest anchor by
    bisection) gives the JAX package's lines byte for byte."""
    for args in GRADED_CASES[case]():
        a, b = tgrid._graded_1d(*args), jgrid._graded_1d(*args)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_example01_light_grids_bit_equal():
    """The device-meshing profiles that ``Executor.prepare_batches`` builds
    for Example_01's log (its first 24 and last 8 batches) equal the JAX
    package's ``build_grid2d_light`` on the same carved models."""
    tasks, formation, borehole, mud = _example01_plan()
    executor = Executor(ExecutorConfig(device="cpu", device_meshing=True))
    grids = executor.prepare_batches(tasks, formation, borehole, mud, 50.0, 0.0, 0.999)
    assert executor.mesher == "device"
    jspec = jgrid.GridSpec2D(**dataclasses.asdict(executor.config.spec))
    for b in list(range(24)) + list(range(len(tasks) - 8, len(tasks))):
        t = tasks[b]
        lm = tcarve.carve_local_model(formation, borehole, float(mud[t.batch_index]),
                                      t.center_depth, 50.0, active_geometry_window=0.999)
        sources = np.unique(np.concatenate([s.source_positions for s in t.solves]))
        ref = jgrid.build_grid2d_light(jspec, 50.0, lm, t.electrode_positions, sources)
        assert grids[b].content_bytes() == ref.content_bytes(), b
