# -*- coding: utf-8 -*-
"""The 3D slice as a whole in float64: the port's ``Model`` against
``remo3d_tpu.Model`` on the CPU with dtype="float64" and tol=1e-12 on both
sides (same problem as tests/test_torch_model3d.py); readouts within 1e-9.
Example_03 (the same BM3 stack at dip 30) and ``bm3_oracle.fem_log`` (BM3
with the oracle's needle borehole and 150 m domain) are held to the JAX log
within 1e-10; the JAX logs here share the float64 3D assembly that JAX
compiles once for the file.

The JAX package's float64 mode turns on ``jax_enable_x64`` for the whole
process, so these cases have a file of their own and restore the flag afterwards.
"""

import jax
import numpy as np
import pytest
import remo3d_tpu
from remo3d_tpu.meshing.grid3d import GridSpec3D as JSpec

from benchmarks import bm3_oracle as jbm3
from remo3d_tpu_torch.examples import example_03_dip
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D as TSpec
from remo3d_tpu_torch.validation import bm3_oracle
from tests.test_torch_model3d import DEPTHS, GRID, TOOLS, run_both

SOLVER = dict(tol=1e-12, dtype="float64",
              executor_overrides={"precond3d": "adi", "use_native_mesher": True})


@pytest.fixture(scope="module")
def f64_logs():
    before = jax.config.jax_enable_x64
    try:
        yield run_both("float64", 1e-12)
    finally:
        jax.config.update("jax_enable_x64", before)


def test_float64_dip30_log_matches_jax(f64_logs):
    port, ref = f64_logs
    for t in TOOLS:
        assert port.logs[t].dtype == np.float64
        np.testing.assert_allclose(port.logs[t][:, 1], ref.logs[t][:, 1], rtol=1e-9)


def test_example_03_matches_jax_float64(f64_logs, tmp_path):
    """Example_03's ``main`` (its two tools, BM3 at dip 30) on the JAX log's
    depths and grid; its results files read back inside ``main``."""
    _, ref = f64_logs
    model, _ = example_03_dip.main(output_folder=str(tmp_path), depths=DEPTHS, device="cpu",
                                   grid_spec3d=TSpec(**GRID), verbose=False, **SOLVER)
    assert list(model.logs) == list(ref.logs) == TOOLS
    for t in TOOLS:
        np.testing.assert_array_equal(model.logs[t][:, 0], ref.logs[t][:, 0])
        np.testing.assert_allclose(model.logs[t][:, 1], ref.logs[t][:, 1], rtol=1e-10)


def test_bm3_fem_log_matches_jax_float64(f64_logs):
    """``fem_log`` against the JAX package's Model on the same stack and tool
    (one tool: the grid follows the tool set, so the solve's shapes differ
    from the two-tool logs and JAX compiles its load and CG again, ~15 s),
    within 1e-10."""
    tool = TOOLS[0]
    m = remo3d_tpu.Model([tool])
    borehole = np.array([[-1000.0, jbm3.BH_RADIUS, jbm3.MUD_RHO],
                         [1000.0, jbm3.BH_RADIUS, jbm3.MUD_RHO]])
    m.set_model_parameters(bm3_oracle.bm3_formation(), borehole,
                           borehole_geometry_type="radius", dip=30)
    m.initialize_workers()
    m.simulate_logs(DEPTHS, domain_radius=jbm3.DOMAIN_RADIUS, platform="cpu", verbose=False,
                    grid_spec3d=JSpec(**GRID), **SOLVER)
    port = bm3_oracle.fem_log(tool, DEPTHS, 30, device="cpu", grid_spec3d=TSpec(**GRID), **SOLVER)
    assert port.dtype == np.float64 and np.isfinite(port).all()
    np.testing.assert_allclose(port, m.logs[tool][:, 1], rtol=1e-10)
