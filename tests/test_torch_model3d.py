# -*- coding: utf-8 -*-
"""The 3D slice as a whole: the port's ``Model`` against ``remo3d_tpu.Model``
on the CPU at dip 30, Benchmark model 3's stack (10 | 100 | 10 ohm-m, beds
crossing the axis at 10.77 and 14.23 m), 2 tools x 3 depths through the bed, on
a 49x5x17 grid, both through the ADI line-preconditioned CG (the CPU default of
both packages is the block-direct solver, tests/test_torch_model_direct.py, so
both sides ask for "adi"). Both mesh natively by default (the shared C++
builders of native/); a second case switches both to their numpy builders, so
each builder keeps a parity test.

float32 readouts agree within 2e-4 relative (two CG solves stopped at tol 1e-5
in float32 that sum in different orders). The float64 case is
tests/test_torch_model3d_f64.py.
"""

import numpy as np
import pytest
import torch

import remo3d_tpu
import remo3d_tpu_torch
from remo3d_tpu.meshing.grid3d import GridSpec3D as JSpec
from remo3d_tpu_torch import model as tmodel
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D as TSpec

torch.set_num_threads(2)

FORMATION = np.array([
    [-100.0, 10.77, np.nan, np.nan, 10.0],
    [10.77, 14.23, np.nan, np.nan, 100.0],
    [14.23, 200.0, np.nan, np.nan, 10.0],
])
BOREHOLE = np.array([[-100.0, 0.1, 1.0], [200.0, 0.1, 1.0]])
TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]
DEPTHS = np.array([11.5, 12.5, 13.5])
GRID = dict(nz=49, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2)


def run_both(dtype, tol, native=True):
    """(port model, JAX model) on the same inputs and solver configuration,
    both meshed natively or both with numpy."""
    common = dict(borehole_geometry_type="radius", dip=30, dtype=dtype, tol=tol, verbose=False,
                  executor_overrides={"precond3d": "adi", "use_native_mesher": native})
    port = remo3d_tpu_torch.Model.compute_synthetic_logs(
        TOOLS, DEPTHS, FORMATION, BOREHOLE, grid_spec3d=TSpec(**GRID), device="cpu", **common)
    ref = remo3d_tpu.Model.compute_synthetic_logs(
        TOOLS, DEPTHS, FORMATION, BOREHOLE, grid_spec3d=JSpec(**GRID), platform="cpu", **common)
    return port, ref


def test_float32_dip30_log_matches_jax():
    check_float32_log(*run_both("float32", None), mesher="native")


def test_float32_dip30_log_matches_jax_numpy_mesher():
    check_float32_log(*run_both("float32", None, native=False), mesher="numpy")


def check_float32_log(port, ref, mesher):
    assert list(port.logs) == list(ref.logs) == TOOLS
    report = port.last_report
    assert report["n_failed_solves"] == 0 and report["device"] == "cpu"
    assert report["mesher"] == mesher
    assert all(0 < c["iterations"] < 1000 for c in report["chunks"])
    for t in TOOLS:
        np.testing.assert_array_equal(port.logs[t][:, 0], ref.logs[t][:, 0])
        assert np.isfinite(port.logs[t][:, 1]).all()
        np.testing.assert_allclose(port.logs[t][:, 1], ref.logs[t][:, 1], rtol=2e-4)


def test_resolve_spec3d_notices():
    """High dip selects the refined grid, a thin invasion annulus refines the
    radial grading, and an explicit spec or override wins: as in the JAX
    package, notices included."""
    from remo3d_tpu import model as jmodel

    thin = FORMATION.copy()
    thin[1, 2:4] = (0.15, 30.0)  # a 0.05 m invaded annulus over the 0.1 m wall
    cases = [
        (30, None, None, FORMATION),
        (50, None, None, FORMATION),
        (60, None, None, thin),
        (30, None, None, thin),
        (60, "explicit", None, thin),
        (60, None, {"spec3d": None}, thin),
    ]
    for dip, explicit, overrides, formation in cases:
        t_spec, t_notes = tmodel._resolve_spec3d(
            dip, TSpec.fast() if explicit else None, overrides, formation, BOREHOLE)
        j_spec, j_notes = jmodel._resolve_spec3d(
            dip, JSpec.fast() if explicit else None, overrides, formation, BOREHOLE)
        assert t_notes == j_notes
        assert (t_spec is None) == (j_spec is None)
        if t_spec is not None:
            assert repr(t_spec).replace("remo3d_tpu_torch", "") == repr(j_spec).replace(
                "remo3d_tpu", "")
    assert tmodel.HIGH_DIP_THRESHOLD_DEG == jmodel.HIGH_DIP_THRESHOLD_DEG
    spec, notes = tmodel._resolve_spec3d(60, None, None, thin, BOREHOLE)
    assert (spec.nz, spec.np_, spec.nr) == (257, 25, 65) and spec.fz_h_radial == pytest.approx(0.0125)
    assert len(notes) == 2 and "high_dip" in notes[0] and "invasion annulus" in notes[1]


def test_3d_options_raise():
    m = remo3d_tpu_torch.Model(["A2.0M0.5N"])
    m.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius", dip=30)
    m.initialize_workers()
    with pytest.raises(ValueError, match="only mesh generator supported in 3D"):
        m.simulate_logs(DEPTHS, device="cpu", verbose=False, mesh_generator="netgen")
    with pytest.raises(ValueError, match="precond3d 'ilu'"):
        m.simulate_logs(DEPTHS, device="cpu", verbose=False,
                        executor_overrides={"precond3d": "ilu"})
