# -*- coding: utf-8 -*-
"""The slice as a whole: the port's ``Model`` against ``remo3d_tpu.Model`` on
the CPU, both through multigrid PCG with on-device meshing, on a 97x33 grid
(4 multigrid levels), 3 tools x 4 depths over an invaded layered formation.

float32 readouts agree within 2e-4 relative (the float32 arithmetic spread:
each float32 log at tol 3e-7 sits within 2.2e-4 of its float64 solve, README
"Solver arithmetic"); the Results_N.txt files written from the same logs are
byte-identical. The float64 case is tests/test_torch_model_f64.py.
"""

import os

import jax
import numpy as np
import pytest
import torch

import remo3d_tpu
import remo3d_tpu_torch
from remo3d_tpu.meshing.grid2d import GridSpec2D as JSpec
from remo3d_tpu.plotting import save_results_impl as j_save
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D as TSpec
from remo3d_tpu_torch.plotting import save_results_impl as t_save

torch.set_num_threads(2)

FORMATION = np.array([
    [-100.0, -1.0, np.nan, np.nan, 10.0],
    [-1.0, 0.5, 0.3, 4.0, 40.0],
    [0.5, 1.5, np.nan, np.nan, 3.0],
    [1.5, 100.0, 0.25, 2.0, 20.0],
])
BOREHOLE = np.array([[-100.0, 0.1, 1.0], [100.0, 0.1, 1.0]])
TOOLS = ["A2.0M0.5N", "B5.7A0.4M", "N0.5M2.0A"]
DEPTHS = np.array([-0.3, 0.0, 0.3, 0.9])
GRID = dict(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2)
OVERRIDES = {"preconditioner": "multigrid", "device_meshing": True}


def run_both(dtype, tol):
    """(port model, JAX model) on the same inputs and solver configuration."""
    common = dict(borehole_geometry_type="radius", dtype=dtype, tol=tol, verbose=False,
                  executor_overrides=OVERRIDES)
    port = remo3d_tpu_torch.Model.compute_synthetic_logs(
        TOOLS, DEPTHS, FORMATION, BOREHOLE, grid_spec=TSpec(**GRID), device="cpu", **common)
    ref = remo3d_tpu.Model.compute_synthetic_logs(
        TOOLS, DEPTHS, FORMATION, BOREHOLE, grid_spec=JSpec(**GRID), platform="cpu", **common)
    return port, ref


@pytest.fixture(scope="module")
def models_f32():
    return run_both("float32", None)


def test_float32_log_matches_jax(models_f32):
    port, ref = models_f32
    assert list(port.logs) == list(ref.logs) == TOOLS
    assert port.last_report["n_failed_solves"] == 0
    assert port.last_report["use_stencil_kernel"] and port.last_report["device"] == "cpu"
    for t in TOOLS:
        np.testing.assert_array_equal(port.logs[t][:, 0], ref.logs[t][:, 0])
        assert np.isfinite(port.logs[t][:, 1]).all()
        np.testing.assert_allclose(port.logs[t][:, 1], ref.logs[t][:, 1], rtol=2e-4)


def test_results_files_byte_identical(models_f32, tmp_path):
    _, ref = models_f32
    folders = [
        save(logs=ref.logs, formation_parameters=ref.formation_model,
             borehole_parameters=ref.borehole_model, dip=0, output_folder=str(tmp_path / name))
        for name, save in (("jax", j_save), ("torch", t_save))
    ]
    names = sorted(f for f in os.listdir(folders[0]) if f.startswith("Results_") and f.endswith(".txt"))
    assert names == ["Results_1.txt"]
    assert sorted(f for f in os.listdir(folders[1]) if f.endswith(".txt")) == names
    blobs = [open(os.path.join(d, names[0]), "rb").read() for d in folders]
    assert blobs[0] == blobs[1]
    assert blobs[1].splitlines()[0] == ("DEPTH\t" + "\t".join(TOOLS)).encode()


def test_unported_options_raise():
    """The JAX package's TPU-only options are not ported and raise: its
    ``platform`` argument (the port takes ``device``) and the Pallas switch
    among the executor overrides (the port's is ``use_stencil_kernel``).
    ``checkpoint`` and ``profile_dir`` are ported (tests/test_torch_checkpoint.py)."""
    m = remo3d_tpu_torch.Model(["A2.0M0.5N"])
    m.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius")
    m.initialize_workers()
    with pytest.raises(TypeError, match="platform"):
        m.simulate_logs(DEPTHS, device="cpu", verbose=False, platform="cpu")
    with pytest.raises(TypeError, match="use_pallas_stencil"):
        m.simulate_logs(DEPTHS, device="cpu", verbose=False,
                        executor_overrides={"use_pallas_stencil": True})


def test_device_default_needs_a_card(monkeypatch):
    """device=None means "cuda": without a visible card the executor raises
    and says how to ask for the CPU; it never runs on the CPU by itself."""
    from remo3d_tpu_torch.parallel.runtime import Executor, ExecutorConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for config in (ExecutorConfig(), ExecutorConfig(device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Executor(config)
    ex = Executor(ExecutorConfig(device="cpu"))
    assert ex.device == torch.device("cpu") and ex.config.precond3d == "direct"
    m = remo3d_tpu_torch.Model(["A2.0M0.5N"])
    m.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius")
    m.initialize_workers()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        m.simulate_logs(DEPTHS, verbose=False)


@pytest.mark.parametrize("fail_residual", [None, 1e30], ids=["default", "1e30"])
def test_unconverged_solves_give_nan_readouts(fail_residual):
    """The reference's per-solve NaN containment: a solve whose attained
    relative residual is above ``fail_residual`` gives NaN readouts, and
    ``last_report`` counts the failed solves and the NaN readouts. One CG
    iteration of point Jacobi leaves every residual near 1, so every solve
    fails at the default 1e-4 and none at 1e30."""
    overrides = {"preconditioner": "local"}
    if fail_residual is not None:
        overrides["fail_residual"] = fail_residual
    tools = TOOLS[:2]
    m = remo3d_tpu_torch.Model.compute_synthetic_logs(
        tools, DEPTHS[:3], FORMATION, BOREHOLE, borehole_geometry_type="radius",
        grid_spec=TSpec(nz=49, nr=17, n_wall_cells=4, n_blend_cells=2), device="cpu",
        verbose=False, maxiter=1, executor_overrides=overrides)
    report = m.last_report
    vals = np.stack([m.logs[t][:, 1] for t in tools])
    n_solves = sum(c["solves"] for c in report["chunks"])
    assert n_solves > 0 and vals.size == len(tools) * 3
    assert all(c["iterations"] == 1 for c in report["chunks"])
    if fail_residual is None:
        assert np.isnan(vals).all()
        assert report["n_failed_solves"] == n_solves
        assert report["n_nan_readouts"] == vals.size
    else:
        assert np.isfinite(vals).all()
        assert report["n_failed_solves"] == report["n_nan_readouts"] == 0
