# -*- coding: utf-8 -*-
"""The port's examples (``remo3d_tpu_torch/examples/``) against the JAX
package's (``examples/``), on the CPU at small sizes.

Examples 01-02: each ``main`` in float64 (tol 1e-12) agrees with the JAX
package's ``Model`` on the same inputs within 1e-10, and its results files
read back. Example_03 and ``bm3_oracle.fem_log`` are held to the JAX 3D log
in tests/test_torch_model3d_f64.py, which compiles that float64 solve (~35 s
of XLA compilation) once for the three tests. Examples 04-05: the JAX example's own ``main`` (its
Levenberg-Marquardt loop) runs on the inline model and a small grid with the
port's ``DifferentiableLog`` in place of the JAX one (float32 in both
packages; tests/test_torch_diff.py and test_torch_diff3d.py hold the two
forwards and Jacobians against each other), and every call it makes is
recorded; the port's example takes the same first two steps within 1e-8
(misfits and parameters).
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

import remo3d_tpu
import remo3d_tpu_torch
from remo3d_tpu.meshing.grid2d import GridSpec2D as JSpec2
from remo3d_tpu_torch.examples import (
    common,
    example_01,
    example_02,
    example_04_inversion,
    example_05_dip_inversion,
)
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D as TSpec2
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D as TSpec3
from remo3d_tpu_torch.plotting import _write_tsv_groups, save_results_impl
from remo3d_tpu_torch.validation import models

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID2 = dict(nz=49, nr=17, n_wall_cells=3, n_blend_cells=2)
GRID3 = dict(nz=49, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2)
F64 = dict(dtype="float64", tol=1e-12)


def x64(fn):
    """``fn()`` with JAX's float64 switched on, restored afterwards."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", before)


def jax_logs(tools, depths, formation, borehole, **kwargs):
    model = x64(lambda: remo3d_tpu.Model.compute_synthetic_logs(
        tools, depths, formation, borehole, borehole_geometry_type="radius", platform="cpu",
        verbose=False, **F64, **kwargs))
    return model.logs


def check_logs(port_logs, ref_logs):
    assert list(port_logs) == list(ref_logs)
    for t in ref_logs:
        np.testing.assert_array_equal(port_logs[t][:, 0], ref_logs[t][:, 0])
        assert np.isfinite(port_logs[t][:, 1]).all()
        np.testing.assert_allclose(port_logs[t][:, 1], ref_logs[t][:, 1], rtol=1e-10)


def test_example_01_matches_jax_float64(tmp_path):
    depths = np.array([0.0, 5.5])
    model, folder = example_01.main(output_folder=str(tmp_path), depths=depths, device="cpu",
                                    grid_spec=TSpec2(**GRID2), verbose=False, **F64)
    assert os.path.isfile(os.path.join(folder, "Results_1.txt"))
    check_logs(model.logs, jax_logs(models.EXAMPLE01_TOOLS, depths, models.BM2_FORMATION,
                                    models.BM2_BOREHOLE, grid_spec=JSpec2(**GRID2)))


def test_example_02_matches_jax_float64(tmp_path):
    """Example_02's options (domain radius 25, batches of 10, "netgen") and
    its figure options: the figure is drawn where matplotlib is installed."""
    depths = np.array([0.0, 5.5])
    model, folder = example_02.main(output_folder=str(tmp_path), depths=depths, device="cpu",
                                    grid_spec=TSpec2(**GRID2), verbose=False, **F64)
    if importlib.util.find_spec("matplotlib") is not None:
        assert os.path.isfile(os.path.join(folder, "Results_plot.png"))
    check_logs(model.logs, jax_logs(
        models.EXAMPLE01_TOOLS, depths, models.BM2_FORMATION, models.BM2_BOREHOLE,
        grid_spec=JSpec2(**GRID2), mesh_generator="netgen", domain_radius=25, batch_size=10,
        cpu_workers=11, gpu_workers=0))


def test_examples_need_a_card_by_default(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example_01.main(output_folder=str(tmp_path), depths=np.array([1.0]),
                        grid_spec=TSpec2(**GRID2), verbose=False)


def test_read_back_catches_a_wrong_value(tmp_path):
    logs = {"A2.0M0.5N": np.array([[0.0, 10.0], [0.1, np.nan]]),
            "B5.7A0.4M": np.array([[0.0, 12.0], [0.1, 12.5]])}
    folder = str(tmp_path)
    _write_tsv_groups(logs, "auto", folder)
    assert common.read_back(folder, logs) == 0.0
    with pytest.raises(AssertionError, match="differs"):
        common.read_back(folder, {**logs, "B5.7A0.4M": logs["B5.7A0.4M"] + [0.0, 1e-3]})
    with pytest.raises(AssertionError, match="hold"):
        common.read_back(folder, {**logs, "M1.0A0.1B": logs["B5.7A0.4M"]})


def test_save_results_without_matplotlib_writes_the_tables(tmp_path, monkeypatch, capsys):
    logs = {"A2.0M0.5N": np.array([[0.0, 10.0], [0.1, 11.0]])}
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # its import raises ImportError
    folder = save_results_impl(logs, models.BM2_FORMATION, models.BM2_BOREHOLE, 0.0,
                               output_folder=str(tmp_path))
    assert os.listdir(folder) == ["Results_1.txt"]
    assert "no figure was drawn" in capsys.readouterr().out
    assert common.read_back(folder, logs) == 0.0
    with pytest.raises(ImportError):
        save_results_impl(logs, models.BM2_FORMATION, models.BM2_BOREHOLE, 0.0)


class Stop(Exception):
    pass


class Recorded:
    """A DifferentiableLog whose forward calls are recorded (parameters and
    values); at the forward of iteration ``stop`` it records the parameters
    and stops the loop (:class:`Stop`)."""

    def __init__(self, dlog, stop, calls):
        self._dlog, self._stop, self.calls = dlog, stop, calls
        self.params0, self.param_names = dlog.params0, dlog.param_names

    def forward(self, p):
        p = np.array(p, dtype=np.float64)
        if len(self.calls) == self._stop + 1:
            self.calls.append((p, None))
            raise Stop
        out = np.asarray(self._dlog.forward(p))
        self.calls.append((p, out))
        return out

    def jacobian(self, p):
        return np.asarray(self._dlog.jacobian(p))


def jax_example_steps(monkeypatch, module_name, steps, **patches):
    """Run the JAX package's example ``module_name`` (its ``main``) with
    ``patches`` on its globals and the port's DifferentiableLog (on the CPU,
    on the model the example set up) until the forward of iteration
    ``steps``; returns the recorded forward calls."""
    spec = importlib.util.spec_from_file_location(
        module_name, os.path.join(REPO, "examples", module_name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []

    def port_dlog(model, depths, **kwargs):
        m = remo3d_tpu_torch.Model(list(model.tools))
        m.set_model_parameters(model.formation_model, model.borehole_model,
                               borehole_geometry_type="radius", dip=model.dip_deg)
        return Recorded(remo3d_tpu_torch.DifferentiableLog(m, depths, device="cpu", **kwargs),
                        steps, calls)

    monkeypatch.setattr(mod, "DifferentiableLog", port_dlog)
    for name, value in patches.items():
        monkeypatch.setattr(mod, name, value)
    with pytest.raises(Stop):
        mod.main()
    return calls


def check_lm_steps(monkeypatch, calls, run):
    """The port's example ``run()`` against the JAX loop's recorded calls:
    the rms log-misfits of iterations 0-1 and the parameters of 0-2."""
    obs = calls[0][1]
    mask = np.isfinite(obs)
    params = [p for p, _ in calls[1:]]
    misfits = []
    for _, sim in calls[1:-1]:  # the examples' arithmetic: logs in float32, the rest float64
        r = (np.log(np.nan_to_num(sim)[mask]) - np.log(obs[mask])).astype(np.float64)
        misfits.append(float(np.sqrt(np.mean(r**2))))
    history = []
    real = common.levenberg_marquardt

    def kept(*args, **kwargs):
        p, h = real(*args, **kwargs)
        history.extend(h)
        return p, h

    monkeypatch.setattr(common, "levenberg_marquardt", kept)
    p_final = run()["params"]
    assert len(history) == len(misfits) == 2 and len(params) == 3
    np.testing.assert_allclose([h["misfit"] for h in history], misfits, rtol=0, atol=1e-8)
    np.testing.assert_allclose([h["params"] for h in history] + [p_final], params, rtol=1e-8)


class Model2D(remo3d_tpu.Model):
    """The JAX Model with Example_04's file inputs replaced by the inline
    BM2-like model."""

    def set_model_parameters(self, *args, **kwargs):
        super().set_model_parameters(models.BM2_FORMATION, models.BM2_BOREHOLE,
                                     borehole_geometry_type="radius")


def test_example_04_first_lm_steps_match_jax(monkeypatch):
    depths = np.array([4.0, 10.0])
    calls = jax_example_steps(monkeypatch, "Example_04_inversion", 2, Model=Model2D,
                              DEPTHS=depths, GRID=TSpec2(**GRID2))
    check_lm_steps(monkeypatch, calls, lambda: example_04_inversion.main(
        depths=depths, grid_spec=TSpec2(**GRID2), n_iter=2, device="cpu"))


def test_example_05_first_lm_steps_match_jax(monkeypatch):
    depths = np.array([1.2, 2.0])
    calls = jax_example_steps(monkeypatch, "Example_05_dip_inversion", 2, DEPTHS=depths,
                              GRID=TSpec3(**GRID3))
    check_lm_steps(monkeypatch, calls, lambda: example_05_dip_inversion.main(
        depths=depths, grid_spec3d=TSpec3(**GRID3), n_iter=2, device="cpu"))
