# -*- coding: utf-8 -*-
"""The port's CG loop (``ops/cg.py``) and the executor's read-ahead pipeline
(``ExecutorConfig.pipeline_window``), on the CPU.

The loop keeps its state in tensors that one iteration updates in place (on a
card every iteration after the first replays a captured CUDA graph; on the CPU
the same step runs op by op). It is held to the JAX package's
``lax.while_loop`` (``remo3d_tpu.ops.cg.pcg``) on the 2D stencil of a 97x33
grid and on the pole-tied 3D operator of a 49x5x17 grid, both packages given
the same operator. float64 (CG tolerance 1e-10): the same iteration count and
the solution within 1e-12 of its magnitude. float32 (1e-5): the solution
within 1e-5 of its magnitude (tests/test_torch_ops.py), the 2D count equal,
the 3D count within 2% (tests/test_torch_ops3d.py: rounding over ~80
iterations of the ADI sweep moves the stopping point by one or two). Both
loops attain the tolerance, with residuals within 1% of it of each other.

Pipeline: windows 1 and 3 give the same readouts, chunk reports and
checkpoint files on logs of three chunks or more (2D host meshing, 2D device
meshing, 3D), and with a window of 3 the next two chunks are meshed while one
solves.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_problem
from remo3d_tpu.ops import assembly2d as jasm2
from remo3d_tpu.ops import assembly3d as jasm3
from remo3d_tpu.ops import block_direct as jbd
from remo3d_tpu.ops import cg as jcg
from remo3d_tpu.ops import lines as jlines
from remo3d_tpu.parallel.runtime import _pcg3 as j_pcg3
from remo3d_tpu_torch import Model
from remo3d_tpu_torch.meshing.carve import carve_local_model
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D, build_grid3d
from remo3d_tpu_torch.ops import block_direct as tbd
from remo3d_tpu_torch.ops import cg as tcg
from remo3d_tpu_torch.ops import lines as tlines
from remo3d_tpu_torch.parallel import runtime
from remo3d_tpu_torch.parallel.runtime import ExecutorConfig
from remo3d_tpu_torch.parallel.runtime import _apply3 as t_apply3
from remo3d_tpu_torch.parallel.runtime import _pcg3 as t_pcg3
from remo3d_tpu_torch.utils.timers import PhaseTimers

torch.set_num_threads(2)
CPU = jax.devices("cpu")[0]
CG_TOL = {"float32": 1e-5, "float64": 1e-10}
U_TOL = {"float32": 1e-5, "float64": 1e-12}
SPEC3D = GridSpec3D(nz=49, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2)
FORMATION = np.array([
    [-100.0, -1.0, np.nan, np.nan, 10.0],
    [-1.0, 1.0, 0.3, 4.0, 100.0],
    [1.0, 100.0, np.nan, np.nan, 10.0],
])
BOREHOLE = np.array([[-100.0, 0.1, 1.0], [100.0, 0.1, 1.0]])
TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]


@pytest.fixture(autouse=True, scope="module")
def x64():
    """float64 on the JAX side, for this file only."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


def close(port, ref, rtol):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * float(np.abs(ref).max()))


def same_residuals(port, ref, tol):
    """Both attain ``tol``, and lie within 1% of it of each other."""
    port, ref = port.numpy(), np.asarray(ref)
    assert port.max() <= tol and ref.max() <= tol
    assert float(np.abs(port - ref).max()) <= 0.01 * tol


def point_loads(shape, dtype, seed):
    """Unit loads at random axis nodes, one per solve; the last slot empty."""
    rng = np.random.default_rng(seed)
    b = np.zeros(shape, dtype=dtype)
    nz = shape[2]
    for bi in range(shape[0]):
        for si in range(shape[1]):
            b[bi, si, rng.integers(nz // 8, nz - nz // 8), ..., 0] = 1.0 / np.prod(shape[3:-1])
    b[-1, -1] = 0.0
    return b


@pytest.mark.parametrize("dtype,precond", [("float64", "line_rz"), ("float64", "scan"),
                                           ("float32", "scan")])
def test_pcg_2d_matches_jax(dtype, precond):
    """The 2D stencil of a 97x33 grid, 2 batches x 3 solves (one empty), under
    the multigrid's line smoother (additive r and z PCR line solves, ~100
    iterations) or the exact block-LDL^T factor (one or two)."""
    arrays = [a.astype(dtype) if a.dtype.kind == "f" else a
              for a in _tiny_problem(nz=97, nr=33, n_batches=2, n_solves=3)]
    b = point_loads((2, 3, 97, 33), dtype, seed=2)
    with jax.default_device(CPU):
        C_j = jasm2.assemble_stencil_2d(*(jnp.asarray(a) for a in arrays[:3]))
        if precond == "line_rz":
            fr, fz = jlines.line_factor_2d(C_j, "r"), jlines.line_factor_2d(C_j, "z")

            def m_j(r):
                return 0.5 * (jlines.line_apply_2d(fr, r) + jlines.line_apply_2d(fz, r))
        else:
            G_j = jbd.block_thomas_factor(C_j, store_dtype=dtype)

            def m_j(r):
                return jbd.block_thomas_apply(G_j, C_j, r)
        u_j, info_j = jcg.pcg(C_j, jnp.asarray(b), M_inv=m_j, tol=CG_TOL[dtype], maxiter=500)
    C_t = torch.tensor(np.asarray(C_j))
    if precond == "line_rz":
        tr, tz = tlines.line_factor_2d(C_t, "r"), tlines.line_factor_2d(C_t, "z")

        def m_t(r):
            return 0.5 * (tlines.line_apply_2d(tr, r) + tlines.line_apply_2d(tz, r))
    else:
        G_t = tbd.block_thomas_factor(C_t)

        def m_t(r):
            return tbd.block_thomas_apply(G_t, C_t, r)
    b_t = torch.as_tensor(b)
    u_t, info_t = tcg.pcg(C_t, b_t, M_inv=m_t, tol=CG_TOL[dtype], maxiter=500)
    assert info_t["iterations"] == int(info_j["iterations"]) >= 1
    assert info_t["capture_seconds"] == 0.0 and info_t["replays"] == 0  # no graph on the CPU
    close(u_t, u_j, U_TOL[dtype])
    same_residuals(info_t["rel_residual"], info_j["rel_residual"], CG_TOL[dtype])
    assert np.array_equal(b_t.numpy(), b)  # the loop updates its own state, not b
    assert float(u_t[-1, -1].abs().max()) == 0.0


def grids_3d():
    grids = []
    for center, dip in ((0.2, 0.3), (-0.4, 0.5)):
        lm = carve_local_model(FORMATION, BOREHOLE, 1.0, center, 50.0, dip_rad=dip)
        grids.append(build_grid3d(SPEC3D, 50.0, lm, dip, np.array([-2.0, 0.0, 2.0]) + center,
                                  np.array([0.0, 2.0]) + center))
    return grids


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pole_tied_pcg_3d_matches_jax(dtype):
    """The pole-tied operator P A P of a 49x5x17 grid at two dips through
    K2's plain version with the fused tie, ADI-preconditioned (``_pcg3``),
    2 batches x 2 solves from axis point loads (one slot empty)."""
    grids = grids_3d()
    coords = np.stack([g.coords for g in grids]).astype(dtype)
    sigma = np.stack([g.sigma_cells for g in grids]).astype(dtype)
    free = np.stack([g.free_mask for g in grids])
    b = point_loads((2, 2, SPEC3D.nz, SPEC3D.np_, SPEC3D.nr), dtype, seed=3)
    offset = np.zeros((2, 2, SPEC3D.nz), dtype=dtype)
    with jax.default_device(CPU):
        C_j = jasm3.assemble_stencil_3d(jnp.asarray(coords), jnp.asarray(sigma),
                                        jnp.asarray(free), metric="cylindrical")
        ua_j, rel_j, it_j = j_pcg3(C_j, jnp.asarray(b), jnp.asarray(offset),
                                   tol=CG_TOL[dtype], maxiter=400, precond="adi")
    C_t = torch.tensor(np.asarray(C_j))
    ua_t, rel_t, it_t = t_pcg3(C_t, torch.as_tensor(b), torch.as_tensor(offset),
                               t_apply3(C_t, True, pole=True), tol=CG_TOL[dtype],
                               maxiter=400, precond="adi")
    if dtype == "float64":
        assert it_t == int(it_j)
    assert 1 < it_t < 400 and abs(it_t - int(it_j)) <= max(1, int(it_j) // 50)
    close(ua_t, ua_j, U_TOL[dtype])
    same_residuals(rel_t, rel_j, CG_TOL[dtype])


SMALL_2D = GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2)
LOGS = {  # name -> (depths, dip, simulate_logs keywords): 3, 3 and 3 chunks
    "2d-host": (np.arange(-0.6, 0.61, 0.2), 0,
                dict(grid_spec=SMALL_2D, executor_overrides={"chunk_size": 3})),
    "2d-device": (np.arange(-0.6, 0.61, 0.2), 0,
                  dict(grid_spec=SMALL_2D, preconditioner="multigrid",
                       executor_overrides={"chunk_size": 3, "device_meshing": True})),
    "3d": (np.arange(-0.5, 0.51, 0.25), 30,
           dict(grid_spec3d=SPEC3D, domain_radius=10.0,
                executor_overrides={"chunk_size_3d": 2})),
}


def run_log(name, window, **more):
    depths, dip, kwargs = LOGS[name]
    kwargs = {**kwargs, **more}
    kwargs["executor_overrides"] = {**kwargs["executor_overrides"], "pipeline_window": window}
    m = Model(TOOLS if dip == 0 else TOOLS[:1])
    m.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius", dip=dip)
    m.initialize_workers(cpu_workers=1)
    m.simulate_logs(depths, device="cpu", batch_size=1, verbose=False, **kwargs)
    return m


@pytest.mark.parametrize("name", list(LOGS))
def test_pipeline_window_keeps_the_log(name, tmp_path):
    """Windows 1 and 3: equal readouts (bitwise), chunk reports and
    checkpoint contents."""
    runs = {}
    for window in (1, 3):
        ckpt = str(tmp_path / f"w{window}.npz")
        m = run_log(name, window, checkpoint=ckpt)
        chunks = [{k: c[k] for k in ("batches", "solves", "iterations", "worst_residual")}
                  for c in m.last_report["chunks"]]
        runs[window] = (m.logs, chunks, dict(np.load(ckpt, allow_pickle=False)))
    (logs1, chunks1, ck1), (logs3, chunks3, ck3) = runs[1], runs[3]
    assert len(chunks1) >= 3 and chunks1 == chunks3
    for tool in logs1:
        assert np.isfinite(logs1[tool][:, 1]).all()
        np.testing.assert_array_equal(logs3[tool], logs1[tool])
    assert sorted(ck1) == sorted(ck3) == ["done_chunks", "key", "results"]
    for k in ck1:
        np.testing.assert_array_equal(ck3[k], ck1[k])


@pytest.mark.parametrize("window", [1, 3])
def test_pipeline_meshes_ahead(window, monkeypatch):
    """While a chunk solves, the chunks of the window after it are meshed
    (host grids counted by their carve calls), and none beyond it; with a
    window of 1 nothing is meshed ahead. Chunks of 3 batches."""
    batches = [c["batches"] for c in run_log("2d-host", 1).last_report["chunks"]]
    assert len(batches) >= 3
    carved, seen = [], []
    lock = threading.Lock()

    def carve(*args, **kwargs):
        with lock:
            carved.append(threading.current_thread().name)
        return carve_local_model(*args, **kwargs)

    solve_direct = runtime._solve_chunk_direct

    def solve(*args, **kwargs):
        want = sum(batches[: len(seen) + window])
        deadline = time.monotonic() + 30.0
        while len(carved) < want and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)  # a mesh beyond the window would show now
        seen.append(len(carved))
        return solve_direct(*args, **kwargs)

    monkeypatch.setattr(runtime, "carve_local_model", carve)
    monkeypatch.setattr(runtime, "_solve_chunk_direct", solve)
    m = run_log("2d-host", window)
    assert [c["batches"] for c in m.last_report["chunks"]] == batches
    assert seen == [sum(batches[: i + window]) for i in range(len(batches))]
    assert len(carved) == sum(batches)
    # The first chunk is meshed on the caller's thread, every later one on
    # the pipeline's when there is a pipeline; the phases say which.
    on_pipeline = [name.startswith("remo3d-pipeline") for name in carved]
    assert on_pipeline == [window > 1 and i >= batches[0] for i in range(len(carved))]
    phases = m.last_report["phases"]
    assert m._executor.timers.counts["stage"] == len(batches)
    assert {"mesh", "stack", "stage", "solve", "readout"} <= set(phases)
    ahead = {"mesh_ahead", "stack_ahead", "pipeline_wait"}
    assert ahead <= set(phases) if window > 1 else not ahead & set(phases)


def test_pipeline_window_is_an_executor_option():
    """``executor_overrides={"pipeline_window": 2}`` is accepted, as in the JAX
    package, and the default window is the JAX package's 3."""
    assert ExecutorConfig().pipeline_window == 3
    m = run_log("2d-host", 2)
    assert m._executor.config.pipeline_window == 2
    assert np.isfinite(m.logs[TOOLS[0]][:, 1]).all()


def test_phase_timers_count_every_phase_across_threads():
    """The pipeline times "mesh" and "stage" on its own thread while the
    caller times "stage" and "solve": 16 threads x 500 phases on 2 names,
    with a short switch interval, lose no count."""
    timers = PhaseTimers()

    def work(i):
        for _ in range(500):
            with timers.phase("stage" if i % 2 else "mesh"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert dict(timers.counts) == {"mesh": 4000, "stage": 4000}


def test_phase_timers_name_a_threads_phases_by_its_suffix():
    """Inside ``suffixed`` a thread's phases take the suffix; another thread's
    phases at the same time, and its own after the block, do not."""
    timers = PhaseTimers()
    inside, release = threading.Event(), threading.Event()

    def pipeline():
        with timers.suffixed("_ahead"):
            with timers.phase("mesh"):
                inside.set()
                release.wait(30)

    t = threading.Thread(target=pipeline)
    t.start()
    assert inside.wait(30)
    with timers.phase("mesh"):
        pass
    release.set()
    t.join(30)
    with timers.phase("mesh"):
        pass
    assert dict(timers.counts) == {"mesh": 2, "mesh_ahead": 1}
