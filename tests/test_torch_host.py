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


_SHUFFLE = np.random.default_rng(7)
PLANNER_CASES = {
    # (tool names, force_single_electrode_configuration, measurement depths, batch size)
    **{f"example01_{n}{suffix}": (EXAMPLE01_TOOLS, force, 0.1 * np.arange(n), 5)
       for n in (101, 251, 1001) for suffix, force in (("", True), ("_no_sec", False))},
    # Unsorted, with repeated depths: the first matching index is in the caller's order.
    **{f"unsorted_repeats{suffix}": (
        TOOL_NAMES, force, _SHUFFLE.permutation(np.repeat(np.round(np.linspace(-2.0, 4.0, 23), 2), 3)), 5)
       for suffix, force in (("", True), ("_no_sec", False))},
    # Above 10 m np.isclose's relative tolerance spans 4-decimal neighbours: depths
    # 1e-4 apart (and a few 1e-6 off) match several measurement depths and sources.
    **{f"relative_tolerance{suffix}": (
        EXAMPLE01_TOOLS, force,
        12.0 + 1e-4 * _SHUFFLE.integers(0, 40, 60) + _SHUFFLE.choice([0.0, 1e-6, -1e-6], 60), 5)
       for suffix, force in (("", True), ("_no_sec", False))},
    # 31 depths in batches of 7: the last batch is padded with NaN.
    "ragged_batch": (TOOL_NAMES[:5], True, np.arange(0.0, 3.01, 0.1), 7),
    "ragged_batch_no_sec": (TOOL_NAMES[:5], False, np.arange(0.0, 3.01, 0.1), 7),
    # Infinite and NaN depths: NaN positions, and a batch's np.unique keeps its NaNs.
    "nonfinite": (TOOL_NAMES[3:6], True, np.array([0.5, np.inf, 1.5, np.nan, -np.inf, 2.5]), 3),
    "nonfinite_no_sec": (TOOL_NAMES[3:6], False, np.array([0.5, np.inf, 1.5, np.nan, -np.inf, 2.5]), 3),
}


def _assert_plan_bytes_equal(a, b):
    """Every array of two plans equal byte for byte, which ``_assert_same`` does
    not check for the sign of a zero or a NaN's payload."""
    def arrays(tasks):
        for t in tasks:
            yield t.electrode_positions
            for s in t.solves:
                yield s.source_positions
                yield s.source_terms
                yield from (r.measuring_positions for r in s.readouts)

    for x, y in zip(arrays(a), arrays(b), strict=True):
        assert x.tobytes() == y.tobytes(), (x, y)


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_planner_bit_equal_cases(case):
    names, force, depths, batch_size = PLANNER_CASES[case]
    jt, jsec = jtools.parse_tools(list(names), force)
    tt, tsec = ttools.parse_tools(list(names), force)
    jd, jtasks = jplanner.plan_tasks(jt, jsec, depths, batch_size)
    td, ttasks = tplanner.plan_tasks(tt, tsec, depths, batch_size)
    assert jsec == tsec
    np.testing.assert_array_equal(jd, td)
    _assert_same(jtasks, ttasks, "tasks")
    _assert_plan_bytes_equal(jtasks, ttasks)


@pytest.mark.parametrize("sec", [True, False])
def test_planner_synthetic_tools_and_types(sec):
    """Tools no tool name parses to: sources 1e-4 apart at 10 m, where np.isclose
    chains (10.0 ~ 10.0001 ~ 10.0002 but not 10.0 ~ 10.0002; a source is dropped
    only when close to one already kept), a tool with no current electrode
    (empty source arrays), and one whose measuring electrodes round to -0.0 and
    +0.0 at its batch's center (the sign a batch's np.unique keeps depends on its
    sort). The plan is bit-equal to the JAX package's, and its scalars and arrays
    have the reference's types."""
    specs = [
        ("chain", [10.0, 10.0001, 10.0002, 11.0], [1.0, -1.0, 1.0, 0.0], 0.0),
        ("pair", [-0.5, 10.0001, 12.0], [0.0, 1.0, 0.0], 0.35),
        ("silent", [-1.0, 1.0], [0.0, 0.0], -1.2345),
        ("signed_zero", [-1e-5, 0.0, 0.7], [0.0, 0.0, 1.0], 0.05),
    ]
    depths = np.array([0.75, 1.95, 1.3, 1.6, 1.55, 2.45, 0.9, 1.3])
    tools = [
        {name: mod.ToolParameters(name, np.array(g), np.array(s), 2.5, shift)
         for name, g, s, shift in specs}
        for mod in (jtools, ttools)
    ]
    jd, jtasks = jplanner.plan_tasks(tools[0], sec, depths, 3)
    td, ttasks = tplanner.plan_tasks(tools[1], sec, depths, 3)
    np.testing.assert_array_equal(jd, td)
    _assert_same(jtasks, ttasks, "tasks")
    _assert_plan_bytes_equal(jtasks, ttasks)

    solves = [s for t in ttasks for s in t.solves]
    readouts = [r for s in solves for r in s.readouts]
    assert all(type(t.center_depth) is float for t in ttasks)
    assert all(type(s.simulation_depth_index) is int for s in solves)
    assert all(type(r.offset) is float and type(r.measurement_index) is int
               and type(r.tool_index) is int for r in readouts)
    assert all(s.source_positions.dtype == np.float64 and s.source_terms.dtype == np.float64
               for s in solves)
    empty = [s for s in solves if s.source_positions.size == 0]
    assert empty and all(s.source_positions.shape == (0,) == s.source_terms.shape for s in empty)
    # The chain's kept sources relative to its first: in SEC mode some solve drops
    # the middle one (close to the first) and keeps the third (close only to the
    # middle); without SEC nothing is dropped.
    chain = [np.round(p[np.abs(p - p[0]) < 0.01] - p[0], 4).tolist()
             for p in (s.source_positions for s in solves if s.readouts[0].tool_index == 0)]
    assert chain and ([0.0, 0.0002] in chain if sec
                      else all(c == [0.0, 0.0001, 0.0002] for c in chain))
    # A solve at its batch's center reads at -0.0 and +0.0.
    assert any(np.signbit(r.measuring_positions[r.measuring_positions == 0]).any()
               for r in readouts)


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
