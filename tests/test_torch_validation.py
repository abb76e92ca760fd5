# -*- coding: utf-8 -*-
"""The port's accuracy scripts (``remo3d_tpu_torch/validation/``) against the
JAX package's ``benchmarks/``, on the CPU.

The finite-volume oracle and the rotated layered-medium oracle are copies:
bit-equal on the same inputs (at reduced oracle grids, n_base 301 and 40
radial stations, so each solve takes well under a second). The FEM sides are
held to the JAX package in float64 within 1e-10 on small grids; the other
scripts run end to end at small sizes. No new module imports JAX.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from benchmarks import bm3_oracle as jbm3
from benchmarks import fv_oracle as jfv
from remo3d_tpu.meshing.grid2d import GridSpec2D as JSpec2
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D as TSpec2
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D as TSpec3
from remo3d_tpu_torch.validation import (
    arithmetic_parity,
    bm2_dip_oracle,
    bm2_oracle,
    bm3_oracle,
    bm_models,
    fv_oracle,
    models,
    oracle_sweep,
    potential_parity,
)

torch.set_num_threads(2)

FV_SMALL = dict(n_base=301, n_r_out=40)
GRID2 = dict(nz=49, nr=17, n_wall_cells=3, n_blend_cells=2)
GRID3 = dict(nz=49, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def x64(fn):
    """``fn()`` with JAX's float64 switched on, restored afterwards."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", before)


@pytest.mark.parametrize("subtract,disc", [(False, False), (True, False), (True, True)])
def test_fv_solve_axis_bit_equal(subtract, disc):
    """The FV solve on the BM2-like conductivities, plain, subtracted, and on
    the disc-shaped truncation."""
    formation = models.BM2_FORMATION
    z = fv_oracle._build_z_grid(10.0, np.array([12.0, 12.5]), formation[:-1, 1], 50.0, 301, 0.004)
    r = fv_oracle._build_r_grid(0.1, np.array([0.2]), 50.0, 9, 40)
    np.testing.assert_array_equal(
        z, jfv._build_z_grid(10.0, np.array([12.0, 12.5]), formation[:-1, 1], 50.0, 301, 0.004))
    np.testing.assert_array_equal(r, jfv._build_r_grid(0.1, np.array([0.2]), 50.0, 9, 40))

    def sigma(zc, rc):
        s = np.where(rc[None, :] < 0.1, 1.0, np.where(np.abs(zc - 10.0)[:, None] < 5, 0.01, 0.1))
        return np.where((rc[None, :] < 0.2) & (rc[None, :] >= 0.1), 0.2, s)

    kw = dict(subtract_sigma0=1.0 if subtract else None, disc_radius=40.0 if disc else None)
    np.testing.assert_array_equal(fv_oracle.fv_solve_axis(10.0, sigma, z, r, **kw),
                                  jfv.fv_solve_axis(10.0, sigma, z, r, **kw))


@pytest.mark.parametrize("tool,profile", [("A2.0M0.5N", False), ("B5.7A0.4M", False),
                                          ("A2.0M0.5N", True)])
def test_fv_apparent_resistivity_bit_equal(tool, profile):
    """The oracle's readout on the BM2-like model, with a constant wall and
    with bm2_dip_oracle's sinusoidal caliper."""
    kw = dict(subtract=True, **FV_SMALL)
    if profile:
        dept, radius = bm2_dip_oracle.caliper_profile()
        kw["rw_profile"] = np.column_stack([dept, radius])
    args = (tool, 10.0, models.BM2_FORMATION, 0.1, 1.0)
    assert fv_oracle.fv_apparent_resistivity(*args, **kw) == jfv.fv_apparent_resistivity(*args, **kw)


@pytest.mark.parametrize("subtract", [False, True])
def test_fv_uniform_full_space_matches_analytic(subtract):
    """tests/test_fv_oracle.py:40 on the port's copy: in a uniform full space
    the truncation deficit is a positive, nearly constant monopole ~1/R and the
    potential differences match the analytic ones within 0.5%."""
    sig = 0.1
    recv = np.array([0.4, 1.0, 5.7])
    R = 25.0
    z = fv_oracle._build_z_grid(0.0, recv, np.array([]), R, 1001, 0.004)
    r_out = 0.1 * np.geomspace(1.0, R / 0.1, 80)
    r = np.unique(np.concatenate([np.linspace(0, 0.1, 9), r_out]))
    u = fv_oracle.fv_solve_axis(0.0, lambda zc, rc: np.full((zc.size, rc.size), sig), z, r,
                                subtract_sigma0=sig if subtract else None)
    uu = np.array([u[int(np.where(z == c)[0][0])] for c in recv])
    ana = 1.0 / (4 * np.pi * sig * recv)
    c_eff = (ana - uu) * 4 * np.pi * sig
    assert np.all(c_eff > 0.3 / R) and np.all(c_eff < 3.0 / R), c_eff
    assert np.ptp(c_eff) < 0.2 / R, c_eff
    assert abs((uu[0] - uu[1]) / (ana[0] - ana[1]) - 1) < 5e-3


def test_fv_logs_in_workers_equal_in_process():
    """The oracle spread over two spawned processes gives the same values."""
    jobs = [(("A2.0M0.5N", z, models.BM2_FORMATION, 0.1, 1.0), {"subtract": True, **FV_SMALL})
            for z in (10.0, 30.0)]
    one, _ = fv_oracle.fv_logs(jobs, 1)
    two, secs = fv_oracle.fv_logs(jobs, 2)
    np.testing.assert_array_equal(one, two)
    assert secs.shape == (2,) and (secs > 0).all()


@pytest.mark.parametrize("dip", [15.0, 30.0, 60.0])
def test_bm3_oracle_log_bit_equal(dip):
    depths = np.array([8.0, 12.5, 14.0, 17.0])
    for tool in bm3_oracle.TOOLS:
        np.testing.assert_array_equal(bm3_oracle.oracle_log(tool, depths, dip, n_lambda=2000),
                                      jbm3.oracle_log(tool, depths, dip, n_lambda=2000))


def test_bm3_oracle_main_reports_worst_per_dip():
    worst = bm3_oracle.main([30], ["A2.0M0.5N"], np.array([12.5]), device="cpu",
                            grid_spec3d=TSpec3(**GRID3))
    assert list(worst) == [30] and 0 < worst[30] < 0.1


def test_potential_fem_matches_jax_float64():
    """``fem_axis_potentials`` (direct, float64) against the JAX package's on
    a 49x17 grid, within 1e-10; the FV side is the copied oracle."""
    from benchmarks import potential_parity as jpp

    kw = dict(preconditioner="direct", tol=1e-12)
    port, res, _ = potential_parity.fem_axis_potentials(
        models.BM1_FORMATION, 13.0, potential_parity.OFFSETS, spec=TSpec2(**GRID2),
        device="cpu", **kw)
    ref, _, _ = x64(lambda: jpp.fem_axis_potentials(
        models.BM1_FORMATION, 13.0, potential_parity.OFFSETS, spec=JSpec2(**GRID2), **kw))
    assert res <= 1e-12
    np.testing.assert_allclose(port, ref, rtol=1e-10)


def test_potential_ladder_runs():
    """The refinement ladder of a 25x9 base grid: three levels, the observed
    order per offset and the remaining-error estimate."""
    out = potential_parity.run_converge(
        (1, 2, 4), device="cpu", base=TSpec2(nz=25, nr=9, n_wall_cells=2, n_blend_cells=1))
    assert len(out["deltas"]) == 2 and out["deltas"][1] < out["deltas"][0]
    assert out["order"].shape == potential_parity.OFFSETS.shape
    assert np.isfinite(out["remaining"]).all()


def test_fem_vs_fv_scripts_run():
    """bm2_oracle, oracle_sweep and bm2_dip_oracle end to end at small sizes
    (FEM 49x17 / 49x5x17, reduced oracle grids): finite, same sign of error
    as at full size (the coarse FEM reads low)."""
    small = dict(device="cpu", fv=FV_SMALL, grid_spec=TSpec2(**GRID2))
    assert 0 < bm2_oracle.main(tools=["A2.0M0.5N"], depths=[10.0], **small) < 0.1
    rows = oracle_sweep.main(tools=["B5.7A0.4M"], depths={"BM1-like": [13.0],
                                                           "BM2-like": [10.0]}, **small)
    assert [r[0] for r in rows] == ["BM1-like", "BM2-like"] and all(0 < r[2] < 0.1 for r in rows)
    out = bm2_dip_oracle.main(depths=np.array([30.0]), grid_spec3d=TSpec3(**GRID3), dip30=True,
                              **small)
    assert 0 < out["fv_worst"] < 0.1 and 0 < out["gap_max"] < 0.1 and out["nan_dip30"] == 0


def test_arithmetic_parity_modes_run():
    """u2d, ra2d and ra3d at small sizes: float32 within 1e-4 of float64."""
    u_max, u_mean = arithmetic_parity.u2d(device="cpu", grid_spec=TSpec2(**GRID2))
    assert 0 < u_mean <= u_max < 1e-4
    s = arithmetic_parity.ra2d(["A2.0M0.5N", "M4.0A0.5B"], np.array([5.0]), device="cpu",
                               grid_spec=TSpec2(**GRID2))
    assert s["per_tool"].shape == (2,) and 0 < s["rms"] <= s["max"] < 1e-4
    s = arithmetic_parity.ra3d(np.array([14.0]), device="cpu", grid_spec3d=TSpec3(**GRID3))
    assert 0 < s["max"] < 1e-4


def test_bm_models_ladder_checks_residuals():
    """The dip ladder NaN-free within the residual bound; a bound no solve
    meets raises."""
    logs = bm_models.run_bm3("cpu", np.array([12.5]), dips=(0, 30), grid_spec=TSpec2(**GRID2),
                             grid_spec3d=TSpec3(**GRID3))
    assert sorted(logs) == [0, 30] and all(np.isfinite(v).all() for v in logs.values())
    with pytest.raises(AssertionError, match="residual"):
        bm_models._run(["A2.0M0.5N"], np.array([12.5]), models.BM3_FORMATION,
                       models.BM3_BOREHOLE, "cpu", tol=1e-3, preconditioner="local",
                       grid_spec=TSpec2(**GRID2))


def test_new_modules_import_no_jax():
    """Importing every example and validation module (and chip_smoke.py's models) leaves no
    ``jax`` and no ``remo3d_tpu`` module loaded."""
    names = [f"remo3d_tpu_torch.examples.{n}" for n in (
        "common", "example_01", "example_02", "example_03_dip", "example_04_inversion",
        "example_05_dip_inversion")] + [f"remo3d_tpu_torch.validation.{n}" for n in (
            "models", "fv_oracle", "bm3_oracle", "bm2_oracle", "oracle_sweep", "bm2_dip_oracle",
            "potential_parity", "arithmetic_parity", "bm_models")]
    code = ("import importlib, json, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "jax" not in loaded and "remo3d_tpu" not in loaded and "remo3d_tpu_torch" in loaded
