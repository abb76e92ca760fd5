# -*- coding: utf-8 -*-
"""The port's numpy host layer (tools, io, planner, carve, grid2d) is a copy of
the JAX package's: same inputs, bit-equal outputs."""

import dataclasses

import numpy as np
import pytest

import remo3d_tpu.io as jio
import remo3d_tpu.meshing.carve as jcarve
import remo3d_tpu.meshing.grid2d as jgrid
import remo3d_tpu.planner as jplanner
import remo3d_tpu.tools as jtools
import remo3d_tpu_torch.io as tio
import remo3d_tpu_torch.meshing.carve as tcarve
import remo3d_tpu_torch.meshing.grid2d as tgrid
import remo3d_tpu_torch.planner as tplanner
import remo3d_tpu_torch.tools as ttools

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
