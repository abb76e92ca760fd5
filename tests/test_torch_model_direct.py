# -*- coding: utf-8 -*-
"""The block-direct slice as a whole: the port's ``Model`` against
``remo3d_tpu.Model`` on the CPU with ``preconditioner="direct"`` (2D, the 97x33
problem of tests/test_torch_model.py) and ``precond3d="direct"`` (3D, the dip-30
49x5x17 problem of tests/test_torch_model3d.py), for each schedule, and with no
overrides at all, where both packages resolve "auto" to the direct solver with
the sequential chain on the CPU.

float32 readouts agree within 2e-4 relative (the float32 arithmetic spread of a
log, README "Solver arithmetic"); float64 readouts at tol 1e-12 within 1e-10.
Also here, without a solve: what "auto" resolves to, and the chunk cap of the
direct factorization against the JAX executor's.
"""

import jax
import numpy as np
import pytest
import torch

import remo3d_tpu
import remo3d_tpu_torch
from remo3d_tpu.meshing.grid2d import GridSpec2D as JSpec2
from remo3d_tpu.meshing.grid3d import GridSpec3D as JSpec3
from remo3d_tpu.parallel import runtime as jrt
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D as TSpec2
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D as TSpec3
from remo3d_tpu_torch.parallel import runtime as trt

from . import test_torch_model as m2
from . import test_torch_model3d as m3

torch.set_num_threads(2)
SCHEDULES = [("scan", None), ("bcr", None), ("fp", 12)]


def run_2d(overrides, dtype="float32", tol=None):
    common = dict(borehole_geometry_type="radius", dtype=dtype, tol=tol, verbose=False)
    port = remo3d_tpu_torch.Model.compute_synthetic_logs(
        m2.TOOLS, m2.DEPTHS, m2.FORMATION, m2.BOREHOLE, grid_spec=TSpec2(**m2.GRID),
        device="cpu", executor_overrides=overrides, **common)
    ref = remo3d_tpu.Model.compute_synthetic_logs(
        m2.TOOLS, m2.DEPTHS, m2.FORMATION, m2.BOREHOLE, grid_spec=JSpec2(**m2.GRID),
        platform="cpu", executor_overrides=overrides, **common)
    return port, ref


def run_3d(overrides, dtype="float32", tol=None):
    common = dict(borehole_geometry_type="radius", dip=30, dtype=dtype, tol=tol, verbose=False)
    port = remo3d_tpu_torch.Model.compute_synthetic_logs(
        m3.TOOLS, m3.DEPTHS, m3.FORMATION, m3.BOREHOLE, grid_spec3d=TSpec3(**m3.GRID),
        device="cpu", executor_overrides=overrides, **common)
    ref = remo3d_tpu.Model.compute_synthetic_logs(
        m3.TOOLS, m3.DEPTHS, m3.FORMATION, m3.BOREHOLE, grid_spec3d=JSpec3(**m3.GRID),
        platform="cpu", executor_overrides=overrides, **common)
    return port, ref


def assert_logs_close(port, ref, tools, rtol, preconditioner, schedule):
    report = port.last_report
    assert report["n_failed_solves"] == 0 and report["device"] == "cpu"
    assert report["preconditioner"] == preconditioner and report["direct_schedule"] == schedule
    assert report["factor_seconds"] > 0
    assert all(0 < c["iterations"] < 1000 for c in report["chunks"])
    for t in tools:
        np.testing.assert_array_equal(port.logs[t][:, 0], ref.logs[t][:, 0])
        assert np.isfinite(port.logs[t][:, 1]).all()
        np.testing.assert_allclose(port.logs[t][:, 1], ref.logs[t][:, 1], rtol=rtol)


@pytest.mark.parametrize("schedule,passes", SCHEDULES)
def test_2d_direct_log_matches_jax(schedule, passes):
    port, ref = run_2d({"preconditioner": "direct", "direct_schedule": schedule,
                        "direct_factor_passes": passes})
    assert_logs_close(port, ref, m2.TOOLS, 2e-4, "direct", schedule)
    exact = schedule != "fp"
    assert all((c["iterations"] <= 6) == exact for c in port.last_report["chunks"])


@pytest.mark.parametrize("schedule,passes", SCHEDULES)
def test_3d_direct_log_matches_jax(schedule, passes):
    port, ref = run_3d({"precond3d": "direct", "direct_schedule": schedule,
                        "direct_factor_passes": passes})
    assert_logs_close(port, ref, m3.TOOLS, 2e-4, "direct", schedule)


def test_2d_log_with_no_overrides_matches_jax():
    """Both packages with nothing chosen: "auto" is the direct solver with the
    sequential chain on the CPU, host meshing, chunk 48."""
    port, ref = run_2d(None)
    assert_logs_close(port, ref, m2.TOOLS, 2e-4, "direct", "scan")
    chunks = port.last_report["chunks"]
    assert len(chunks) == 1 and port.last_report["chunk"] == chunks[0]["batches"] < 48


def test_3d_log_with_no_overrides_matches_jax():
    port, ref = run_3d(None)
    assert_logs_close(port, ref, m3.TOOLS, 2e-4, "direct", "scan")


@pytest.mark.parametrize("schedule", ["scan", "bcr"])
def test_float64_direct_logs_match_jax(schedule):
    """float64 at tol 1e-12, 2D and 3D: readouts within 1e-10. The JAX package
    keeps its factor in float32 whatever the solve's type and the port in the
    solve's type, so the iteration counts differ; both reach the tolerance."""
    before = jax.config.jax_enable_x64
    try:
        port2, ref2 = run_2d({"preconditioner": "direct", "direct_schedule": schedule},
                             "float64", 1e-12)
        port3, ref3 = run_3d({"precond3d": "direct", "direct_schedule": schedule},
                             "float64", 1e-12)
    finally:
        jax.config.update("jax_enable_x64", before)
    # 2D: the factor is the inverse. 3D: P·apply(P·r) is not quite (PAP)^-1.
    for port, ref, tools, most in ((port2, ref2, m2.TOOLS, 3), (port3, ref3, m3.TOOLS, 10)):
        assert all(c["iterations"] <= most for c in port.last_report["chunks"])
        for t in tools:
            assert port.logs[t].dtype == np.float64
            np.testing.assert_allclose(port.logs[t][:, 1], ref.logs[t][:, 1], rtol=1e-10)


def test_auto_resolution_on_the_cpu():
    """CPU: "auto" is "direct" in 2D and 3D with the chain; a pass count means
    "fp" unless "bcr" was asked for; unknown names are refused."""
    Executor, Config = trt.Executor, trt.ExecutorConfig
    cfg = Executor(Config(device="cpu")).config
    assert (cfg.preconditioner, cfg.precond3d, cfg.direct_schedule) == ("direct", "direct", "scan")
    ref = jrt.Executor(jrt.ExecutorConfig(platform="cpu")).config
    assert (ref.preconditioner, ref.precond3d, ref.direct_schedule) == ("direct", "direct", "scan")
    assert Executor(Config(device="cpu", direct_factor_passes=4)).config.direct_schedule == "fp"
    assert Executor(Config(device="cpu", direct_schedule="scan",
                           direct_factor_passes=4)).config.direct_schedule == "fp"
    assert Executor(Config(device="cpu", direct_schedule="bcr",
                           direct_factor_passes=4)).config.direct_schedule == "bcr"
    explicit = Executor(Config(device="cpu", preconditioner="multigrid", precond3d="adi")).config
    assert (explicit.preconditioner, explicit.precond3d) == ("multigrid", "adi")
    for bad in ({"preconditioner": "cholesky"}, {"precond3d": "ilu"}, {"direct_schedule": "pcr"}):
        with pytest.raises(ValueError, match="use 'auto' or one of"):
            Executor(Config(device="cpu", **bad))


class _Grid3D(jrt.Grid3D):
    """A 3D grid that is only a shape, for the JAX executor's chunk arithmetic:
    staging it stops the run."""

    def __init__(self, shape):
        self.coords = np.broadcast_to(np.float32(0), shape + (3,))

    @property
    def sigma_cells(self):
        raise _Stop


class _Stop(Exception):
    pass


CAP_CASES = [
    # (NZ, NP, NR), schedule, passes, expected batches per chunk
    ((193, 17, 49), "scan", None, 8),   # G 535.7 MB per batch: 11 fit in 6 GB
    ((193, 17, 49), "bcr", None, 6),    # 3.5 GB
    ((193, 17, 49), "fp", 6, 5),        # 3 GB
    ((257, 25, 65), "scan", None, 2),   # G 2.71 GB per batch
    ((257, 25, 65), "bcr", None, 2),    # never below 2
    ((129, 17, 65), "scan", None, 8),   # G 630 MB per batch: 9 fit in 6 GB
    ((129, 17, 65), "bcr", None, 5),
    ((129, 17, 65), "fp", 4, 4),
]


@pytest.mark.parametrize("shape,schedule,passes,expected", CAP_CASES)
def test_direct_chunk_cap_equals_jax(shape, schedule, passes, expected):
    """Arithmetic only: on the CPU the direct factorization caps the 3D chunk
    as the JAX executor does (G within 6 / 3 / 3.5 GB for scan / fp / bcr,
    never below 2). The JAX executor's chunk is read from its report after its
    first staging is stopped; it also rounds the chunk up to an even count and
    holds grids above 180,000 nodes to 2, which the port does not."""
    overrides = dict(precond3d="direct", direct_schedule=schedule, direct_factor_passes=passes)
    ex = trt.Executor(trt.ExecutorConfig(device="cpu", **overrides))
    cap = ex._direct_chunk_cap(ex.config.chunk_size_3d, shape)
    assert cap == expected
    other = trt.Executor(trt.ExecutorConfig(device="cpu", precond3d="adi", **{
        k: v for k, v in overrides.items() if k != "precond3d"}))
    assert other._direct_chunk_cap(8, shape) == 8  # no cap without the factorization
    assert ex._direct_chunk_cap(48, shape[::2]) == 48  # nor on a 2D grid on the CPU

    jex = jrt.Executor(jrt.ExecutorConfig(platform="cpu", **overrides))
    jex._devices = jex._devices[:1]  # one device, as the port has
    task = type("Task", (), {"solves": [None] * 5})()
    with pytest.raises(_Stop):
        jex.run([task] * 40, [_Grid3D(shape)] * 40, 1, 1)
    n_nodes = int(np.prod(shape))
    want = 2 if n_nodes > 180_000 else expected + expected % 2
    assert jex.last_report["chunk"] == want
