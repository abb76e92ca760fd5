# -*- coding: utf-8 -*-
"""Tests of the port that need a CUDA card (marker ``cuda``); here they skip.

This file imports neither jax nor the JAX package, so it also runs where jax
is not installed. On a machine with a card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``.
"""

import math
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (
    BM3_BOREHOLE,
    BM3_FORMATION,
    KERNEL3D_SHAPES,
    TOL_POLE,
    random_symmetric_stencil_2d,
    random_symmetric_stencil_3d,
    run_child,
)
from remo3d_tpu_torch import Model
from remo3d_tpu_torch.kernels import build, pcr_lines, stencil2d, stencil3d
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D
from remo3d_tpu_torch.ops import block_bcr, block_bcr3d, block_direct, block_direct3d, cg, lines
from remo3d_tpu_torch.ops.stencil import stencil_apply
from remo3d_tpu_torch.ops.stencil3d import pole_project, stencil3d_apply

# The last has NZ no multiple of the tile height and NR no multiple of 4.
SHAPES = [(1, 2, 7, 5), (2, 3, 33, 17), (3, 5, 97, 33), (2, 3, 37, 23)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda_device, shape, dtype, tol):
    """K1 against its plain version on the card, to summation-order rounding
    (relative to max|y|); each call is one launch."""
    rng = np.random.default_rng(5)
    B, S, NZ, NR = shape
    C = torch.as_tensor(random_symmetric_stencil_2d(rng, B, NZ, NR), device=cuda_device)
    C_half = stencil2d.half_planes_2d(C.to(dtype))
    u = torch.as_tensor(rng.standard_normal(shape), device=cuda_device).to(dtype)
    before = stencil2d.LAUNCHES
    out = stencil2d.stencil_apply_half_2d(C_half, u)
    torch.cuda.synchronize()
    assert stencil2d.LAUNCHES == before + 1
    ref = stencil2d.stencil_apply_half_2d_plain(C_half, u)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
def test_small_log_on_card_matches_cpu(cuda_device):
    """A small float64 log on the card (kernel path) equals the CPU run (plain
    path) to the CG tolerance, and went through the kernel."""
    formation = np.array([
        [-100.0, -1.0, np.nan, np.nan, 10.0],
        [-1.0, 0.5, 0.3, 4.0, 40.0],
        [0.5, 100.0, np.nan, np.nan, 3.0],
    ])
    borehole = np.array([[-100.0, 0.1, 1.0], [100.0, 0.1, 1.0]])
    kw = dict(borehole_geometry_type="radius", verbose=False, dtype="float64", tol=1e-12,
              grid_spec=GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2),
              executor_overrides={"device_meshing": True, "preconditioner": "multigrid"})
    tools, depths = ["A2.0M0.5N", "B5.7A0.4M"], np.array([-0.2, 0.3])
    before = stencil2d.LAUNCHES
    gpu = Model.compute_synthetic_logs(tools, depths, formation, borehole, device="cuda", **kw)
    assert stencil2d.LAUNCHES > before
    cpu = Model.compute_synthetic_logs(tools, depths, formation, borehole, device="cpu", **kw)
    for t in tools:
        np.testing.assert_allclose(gpu.logs[t][:, 1], cpu.logs[t][:, 1], rtol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("pole", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", KERNEL3D_SHAPES)
def test_kernel3d_matches_plain(cuda_device, shape, dtype, tol, pole):
    """K2 against its plain version on the card at the 3D path's chunk shape,
    the high_dip grid, an edge case, a shape whose NZ is no multiple of the
    tile height and one lower than a tile (relative to max|y|); one launch
    each. With the pole tie also against the kernel between two pole_project
    calls, which differs only in the order of the mean over the azimuth
    (1e-6 of max|y| in float32, 1e-13 in float64); u is not modified."""
    rng = np.random.default_rng(6)
    B, S, NZ, NP, NR = shape
    C = torch.as_tensor(random_symmetric_stencil_3d(rng, B, NZ, NP, NR), device=cuda_device)
    C_half = stencil3d.half_planes_3d(C.to(dtype))
    u = torch.as_tensor(rng.standard_normal(shape), device=cuda_device).to(dtype)
    u_before = u.clone()
    before = stencil3d.LAUNCHES
    out = stencil3d.stencil3d_apply_half(C_half, u, pole=pole)
    torch.cuda.synchronize()
    assert stencil3d.LAUNCHES == before + 1
    assert torch.equal(u, u_before)
    ref = stencil3d.stencil3d_apply_half_plain(C_half, u, pole=pole)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= tol * scale
    if pole:
        composed = pole_project(stencil3d.stencil3d_apply_half(C_half, pole_project(u)))
        name = "float32" if dtype == torch.float32 else "float64"
        assert float((out - composed).abs().max()) <= TOL_POLE[name] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_refuse_a_grid_beyond_shared_memory(cuda_device, dtype):
    """One solve's three planes (K2) or three rows (K1) must fit in the 227 KB
    of shared memory a block may have; a larger grid raises, with no fallback
    and no count."""
    np_, nr = 300, 300  # 3 planes x 90,000 nodes x 4 B = 1.08 MB
    C_half = torch.zeros((1, 14, 3, np_, nr), dtype=dtype, device=cuda_device)
    u = torch.zeros((1, 1, 3, np_, nr), dtype=dtype, device=cuda_device)
    before = stencil3d.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        stencil3d.stencil3d_apply_half(C_half, u)
    assert stencil3d.LAUNCHES == before
    nr2 = 30000  # 3 rows x 30,000 nodes x 4 B = 360 KB
    C2 = torch.zeros((1, 5, 3, nr2), dtype=dtype, device=cuda_device)
    u2 = torch.zeros((1, 1, 3, nr2), dtype=dtype, device=cuda_device)
    before = stencil2d.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        stencil2d.stencil_apply_half_2d(C2, u2)
    assert stencil2d.LAUNCHES == before


@pytest.mark.cuda
def test_kernel3d_takes_solves_in_groups_when_they_do_not_fit(cuda_device):
    """Planes so large that not all S slabs fit in shared memory: the kernel
    takes the solves in groups and still agrees with its plain version."""
    shape = (1, 4, 5, 60, 100)  # 3 planes x 6000 nodes x 8 B = 144 KB per solve
    rng = np.random.default_rng(8)
    B, S, NZ, NP, NR = shape
    C = torch.as_tensor(random_symmetric_stencil_3d(rng, B, NZ, NP, NR), device=cuda_device)
    C_half = stencil3d.half_planes_3d(C)
    u = torch.as_tensor(rng.standard_normal(shape), device=cuda_device)
    assert stencil3d.kernel_info(S, NP, NR, torch.float64)["solves_per_group"] < S
    for pole in (False, True):
        out = stencil3d.stencil3d_apply_half(C_half, u, pole=pole)
        ref = stencil3d.stencil3d_apply_half_plain(C_half, u, pole=pole)
        assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
def test_small_3d_log_on_card_matches_cpu(cuda_device):
    """A 3-depth float64 dip-30 log on the card (kernel path) equals the CPU
    run (plain path) to the CG tolerance, and went through K2."""
    kw = dict(borehole_geometry_type="radius", dip=30, verbose=False, dtype="float64",
              tol=1e-10, grid_spec3d=GridSpec3D(nz=49, np_=9, nr=17, n_wall_cells=3,
                                                n_blend_cells=2),
              executor_overrides={"precond3d": "adi"})
    tools, depths = ["A2.0M0.5N", "B5.7A0.4M"], np.array([11.5, 12.5, 13.5])
    before = stencil3d.LAUNCHES
    gpu = Model.compute_synthetic_logs(tools, depths, BM3_FORMATION, BM3_BOREHOLE,
                                       device="cuda", **kw)
    assert stencil3d.LAUNCHES > before
    cpu = Model.compute_synthetic_logs(tools, depths, BM3_FORMATION, BM3_BOREHOLE,
                                       device="cpu", **kw)
    for t in tools:
        np.testing.assert_allclose(gpu.logs[t][:, 1], cpu.logs[t][:, 1], rtol=1e-8)


def _direct_case(dim, schedule, device, dtype):
    """(factor(), apply(F), residual(x), b) of a random SPD operator: 2D
    (2, 3, 65, 33), 3D (2, 3, 17, 5, 9)."""
    rng = np.random.default_rng(11)
    if dim == 2:
        C = torch.as_tensor(random_symmetric_stencil_2d(rng, 2, 65, 33), device=device).to(dtype)
        b = torch.as_tensor(rng.standard_normal((2, 3, 65, 33)), device=device).to(dtype)
        if schedule == "bcr":
            return (lambda: block_bcr.bcr_factor(C), lambda F: block_bcr.bcr_apply(F, b),
                    lambda x: stencil_apply(C, x) - b, b)
        return (lambda: block_direct.block_thomas_factor(C),
                lambda F: block_direct.block_thomas_apply(F, C, b),
                lambda x: stencil_apply(C, x) - b, b)
    C = torch.as_tensor(random_symmetric_stencil_3d(rng, 2, 17, 5, 9), device=device).to(dtype)
    b = torch.as_tensor(rng.standard_normal((2, 3, 17, 5, 9)), device=device).to(dtype)
    if schedule == "bcr":
        return (lambda: block_bcr3d.bcr_factor_3d(C, 5, 9),
                lambda F: block_bcr3d.bcr_apply_3d(F, b, 5, 9),
                lambda x: stencil3d_apply(C, x) - b, b)
    return (lambda: block_direct3d.block_thomas_factor_3d(C, 5, 9),
            lambda F: block_direct3d.block_thomas_apply_3d(F, C, b, 5, 9),
            lambda x: stencil3d_apply(C, x) - b, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("schedule", ["scan", "bcr"])
@pytest.mark.parametrize("dim", [2, 3])
def test_direct_apply_on_card_matches_cpu(cuda_device, dim, schedule, dtype, tol):
    """Factor and apply on the card against the same on the CPU (relative to
    max|x|), and as an inverse (residual <= 3e-5 of max|b| in float32)."""
    xs = {}
    for device in (cuda_device, torch.device("cpu")):
        factor, apply, residual, b = _direct_case(dim, schedule, device, dtype)
        x = apply(factor())
        assert float(residual(x).abs().max()) <= 3e-5 * float(b.abs().max())
        xs[device.type] = x.cpu()
    assert float((xs["cuda"] - xs["cpu"]).abs().max()) <= tol * float(xs["cpu"].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["scan", "bcr"])
@pytest.mark.parametrize("dim", [2, 3])
def test_direct_solver_ignores_the_callers_tf32(cuda_device, dim, schedule):
    """With TF32 products switched on by the caller the direct factor and apply
    give the same result, bit for bit, as with them off, and the caller's
    setting is unchanged afterwards."""
    factor, apply, residual, b = _direct_case(dim, schedule, cuda_device, torch.float32)
    before = torch.get_float32_matmul_precision()
    out = {}
    try:
        for setting in ("highest", "high"):
            torch.set_float32_matmul_precision(setting)
            out[setting] = apply(factor())
            assert torch.get_float32_matmul_precision() == setting
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(out["highest"], out["high"])
    assert float(residual(out["high"]).abs().max()) <= 3e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,passes", [("scan", None), ("bcr", None), ("fp", 12)])
def test_small_direct_logs_on_card(cuda_device, schedule, passes):
    """A small float32 direct log per schedule, 2D (97x33) and 3D (49x9x17):
    no failed solve, readouts within 2e-4 / 1e-3 of the multigrid / "adi" log
    on the card, the CG matvec went through K1 / K2, and under an exact factor
    ("scan", "bcr") CG takes at most 8 iterations per chunk (a factor that has
    gone wrong still lets CG converge, in tens of iterations)."""
    formation = np.array([
        [-100.0, -1.0, np.nan, np.nan, 10.0],
        [-1.0, 0.5, 0.3, 4.0, 40.0],
        [0.5, 100.0, np.nan, np.nan, 3.0],
    ])
    borehole = np.array([[-100.0, 0.1, 1.0], [100.0, 0.1, 1.0]])
    direct = {"direct_schedule": schedule, "direct_factor_passes": passes}
    kw2 = dict(borehole_geometry_type="radius", verbose=False, device="cuda",
               grid_spec=GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2))
    kw3 = dict(borehole_geometry_type="radius", dip=30, verbose=False, device="cuda",
               grid_spec3d=GridSpec3D(nz=49, np_=9, nr=17, n_wall_cells=3, n_blend_cells=2))
    tools = ["A2.0M0.5N", "B5.7A0.4M"]
    cases = (
        (stencil2d, np.array([-0.2, 0.3]), formation, borehole, kw2, "preconditioner",
         "multigrid", 2e-4),
        (stencil3d, np.array([11.5, 12.5, 13.5]), BM3_FORMATION, BM3_BOREHOLE, kw3, "precond3d",
         "adi", 1e-3),
    )
    for kernel, depths, form, bore, kw, key, iterative, rtol in cases:
        ref = Model.compute_synthetic_logs(tools, depths, form, bore,
                                           executor_overrides={key: iterative}, **kw)
        before = kernel.LAUNCHES
        log = Model.compute_synthetic_logs(tools, depths, form, bore,
                                           executor_overrides={key: "direct", **direct}, **kw)
        per_chunk = [c["iterations"] for c in log.last_report["chunks"]]
        iters = sum(per_chunk)
        assert kernel.LAUNCHES - before >= iters > 0
        assert schedule == "fp" or max(per_chunk) <= 8
        assert log.last_report["n_failed_solves"] == 0
        assert log.last_report["factor_seconds"] > 0
        for t in tools:
            np.testing.assert_allclose(log.logs[t][:, 1], ref.logs[t][:, 1], rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape,pole", [
    ("K1", (3, 5, 97, 33), None), ("K1", (2, 3, 37, 23), None),
    ("K2", (2, 5, 33, 5, 17), False), ("K2", (2, 5, 33, 5, 17), True),
    ("K2", (2, 3, 11, 5, 7), True),
])
def test_kernel_gradients_match_plain(cuda_device, kernel, shape, pole):
    """StencilApplyHalf2D / 3D on the card: the output carries a grad_fn, and
    grad_u and grad_C_half of a random projection equal autograd of the plain
    version to 1e-5 of max|grad| (float32); the backward launches the kernel
    once (grad_u)."""
    rng = np.random.default_rng(9)
    B = shape[0]
    if kernel == "K1":
        mod = stencil2d
        C = stencil2d.half_planes_2d(torch.as_tensor(
            random_symmetric_stencil_2d(rng, B, *shape[2:]), device=cuda_device).float())
        apply_, plain = stencil2d.stencil_apply_half_2d, stencil2d.stencil_apply_half_2d_plain
    else:
        mod = stencil3d
        C = stencil3d.half_planes_3d(torch.as_tensor(
            random_symmetric_stencil_3d(rng, B, *shape[2:]), device=cuda_device).float())
        apply_ = lambda C, u: stencil3d.stencil3d_apply_half(C, u, pole)  # noqa: E731
        plain = lambda C, u: stencil3d.stencil3d_apply_half_plain(C, u, pole)  # noqa: E731
    C.requires_grad_(True)
    u = torch.randn(shape, device=cuda_device, requires_grad=True)
    g = torch.randn(shape, device=cuda_device)
    y = apply_(C, u)
    assert y.grad_fn is not None
    before = mod.LAUNCHES
    grads = torch.autograd.grad((y * g).sum(), (C, u))
    assert mod.LAUNCHES == before + 1
    refs = torch.autograd.grad((plain(C, u) * g).sum(), (C, u))
    for a, b in zip(grads, refs):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pole", [((1, 2, 7, 5), None), ((1, 2, 6, 3, 5), False),
                                        ((1, 2, 6, 3, 5), True)])
def test_kernel_gradcheck_float64(cuda_device, shape, pole):
    """torch.autograd.gradcheck of the kernels' Functions in float64, reverse
    and forward mode (the jvp: two launches)."""
    rng = np.random.default_rng(10)
    if pole is None:
        C = stencil2d.half_planes_2d(torch.as_tensor(
            random_symmetric_stencil_2d(rng, 1, *shape[2:]), device=cuda_device))
        fn = stencil2d.stencil_apply_half_2d
    else:
        C = stencil3d.half_planes_3d(torch.as_tensor(
            random_symmetric_stencil_3d(rng, 1, *shape[2:]), device=cuda_device))
        fn = lambda C, u: stencil3d.stencil3d_apply_half(C, u, pole)  # noqa: E731
    u = torch.randn(shape, device=cuda_device, dtype=torch.float64)
    assert torch.autograd.gradcheck(fn, (C.requires_grad_(True), u.requires_grad_(True)),
                                    check_forward_ad=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_small_differentiable_log_on_card(cuda_device, dim):
    """A tiny DifferentiableLog on the card: the forward, torch.autograd.grad
    and the Jacobian each launch K1 (2D) / K2 (3D); the card's forward and
    Jacobian agree with the CPU's (1e-4, and 1e-3 of scale), and reverse mode
    with the Jacobian's projection (2e-3 of scale)."""
    from remo3d_tpu_torch import DifferentiableLog

    if dim == 2:
        model = Model(["A2.0M0.5N", "B5.7A0.4M"])
        model.set_model_parameters(
            np.array([[-100.0, 2.0, np.nan, np.nan, 10.0], [2.0, 3.0, 0.3, 5.0, 100.0],
                      [3.0, 200.0, np.nan, np.nan, 10.0]]),
            np.array([[-100.0, 0.1, 1.0], [200.0, 0.1, 1.0]]), borehole_geometry_type="radius")
        kw = dict(grid_spec=GridSpec2D(nz=97, nr=33, n_wall_cells=6, n_blend_cells=3))
        depths, kernel = np.array([2.0, 2.5, 3.0]), stencil2d
    else:
        model = Model(["A0.4M0.1N"])
        model.set_model_parameters(
            np.array([[-1000.0, 1.0, np.nan, np.nan, 10.0], [1.0, 2.2, 0.4, 5.0, 100.0],
                      [2.2, 1000.0, np.nan, np.nan, 10.0]]),
            np.array([[-1000.0, 0.1, 1.0], [1000.0, 0.1, 1.0]]),
            borehole_geometry_type="radius", dip=30)
        kw = dict(grid_spec3d=GridSpec3D(nz=33, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2),
                  domain_radius=10.0)
        depths, kernel = np.array([1.2, 1.6, 2.0]), stencil3d
    card = DifferentiableLog(model, depths, chunk_size=4, device="cuda", **kw)
    cpu = DifferentiableLog(model, depths, chunk_size=4, device="cpu", **kw)
    p0 = card.params0
    launches = []
    before = kernel.LAUNCHES
    out = card.forward(p0)
    launches.append(kernel.LAUNCHES - before)
    p = torch.tensor(p0, device=cuda_device, dtype=torch.float32, requires_grad=True)
    w = torch.randn(out.shape, device=cuda_device)
    logs = card(p)
    loss = torch.where(torch.isnan(logs), 0.0, logs * w).sum()
    before = kernel.LAUNCHES
    (g,) = torch.autograd.grad(loss, p)
    launches.append(kernel.LAUNCHES - before)
    before = kernel.LAUNCHES
    J = card.jacobian(p0)
    launches.append(kernel.LAUNCHES - before)
    assert min(launches) > 0, launches
    np.testing.assert_allclose(out.cpu().numpy(), cpu.forward(p0).numpy(), rtol=1e-4)
    J_cpu = cpu.jacobian(p0).numpy()
    J = J.cpu().numpy()
    assert np.abs(J - J_cpu).max() <= 1e-3 * np.abs(J_cpu).max()
    g_fwd = np.einsum("mtp,mt->p", J, w.cpu().numpy())
    assert np.abs(g.cpu().numpy() - g_fwd).max() <= 2e-3 * np.abs(g_fwd).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dim,route", [(2, "multigrid"), (2, "direct"), (3, "adi"),
                                       (3, "direct")])
def test_graphed_cg_matches_op_by_op(cuda_device, dim, route):
    """A small float32 log of one solve per batch (2D 97x33, 3D 49x9x17) in
    chunks of 2 batches, with ops/cg.py's CUDA graphs on and off: bit-equal readouts,
    the same CG iterations per chunk and the same kernel launches; each chunk
    replays its graph once per iteration after the first."""
    tools = ["A2.0M0.5N", "B5.7A0.4M"]
    if dim == 2:
        kernel, key = stencil2d, "preconditioner"
        depths, form, bore = np.array([-0.4, -0.2, 0.0, 0.3, 0.6]), BM3_FORMATION, BM3_BOREHOLE
        kw = dict(grid_spec=GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2))
        overrides = {"chunk_size": 2}
    else:
        kernel, key = stencil3d, "precond3d"
        depths, form, bore = np.array([11.5, 12.5, 13.5]), BM3_FORMATION, BM3_BOREHOLE
        kw = dict(dip=30, grid_spec3d=GridSpec3D(nz=49, np_=9, nr=17, n_wall_cells=3,
                                                  n_blend_cells=2))
        overrides = {"chunk_size_3d": 2}
    runs = {}
    for graphs in (True, False):
        cg.GRAPHS = graphs
        try:
            before = kernel.LAUNCHES, pcr_lines.LAUNCHES
            m = Model.compute_synthetic_logs(
                tools, depths, form, bore, borehole_geometry_type="radius", device="cuda",
                batch_size=1, verbose=False, executor_overrides={key: route, **overrides}, **kw)
            runs[graphs] = (m, (kernel.LAUNCHES - before[0], pcr_lines.LAUNCHES - before[1]))
        finally:
            cg.GRAPHS = True
    (mg, ng), (me, ne) = runs[True], runs[False]
    chunks = mg.last_report["chunks"]
    assert len(chunks) >= 2 and ng == ne and ng[0] > 0
    assert (ng[1] > 0) == (route != "direct")  # K3 runs inside the graph of the line smoothers
    assert [c["iterations"] for c in chunks] == [c["iterations"] for c in me.last_report["chunks"]]
    assert all(c["replays"] == c["iterations"] - 1 for c in chunks)
    assert all(c["capture_seconds"] > 0 for c in chunks if c["replays"])
    assert all(c["replays"] == 0 for c in me.last_report["chunks"])
    for t in tools:
        np.testing.assert_array_equal(mg.logs[t], me.logs[t])


def _pcr_inputs(rng, shape, axis, solve_axis, dtype, device):
    """Stacked factors of random diagonally dominant lines (an M-matrix, as the
    FEM operators' lines are) on the grid shape[2:], and b; float64 made, then
    cast."""
    B, S, grid = shape[0], shape[1], shape[2:]
    dl = -rng.uniform(0.1, 1.0, (B, *grid))
    du = -rng.uniform(0.1, 1.0, (B, *grid))
    d = -(dl + du) + rng.uniform(0.05, 0.5, (B, *grid))
    F = lines.pcr_factor_stacked(
        *(torch.as_tensor(a, device=device).to(dtype) for a in (dl, d, du)), axis=axis,
        stack_dim=1)
    b = rng.standard_normal((B, S, *grid) if solve_axis else (B, *grid))
    return F, torch.as_tensor(b, device=device).to(dtype)


# (shape, axis): 2D r and z lines, 3D z, p and r lines, lines of 9 to 49 nodes.
PCR_CASES = [((2, 3, 33, 17), -1), ((2, 3, 33, 17), -2), ((2, 3, 17, 9, 49), -3),
             ((2, 3, 17, 9, 49), -2), ((2, 3, 17, 9, 49), -1), ((3, 5, 97, 33), -2)]


@pytest.mark.cuda
@pytest.mark.parametrize("solve_axis", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape,axis", PCR_CASES)
def test_pcr_kernel_matches_plain(cuda_device, shape, axis, dtype, tol, solve_axis):
    """K3 against its plain version on the card, relative to max|x|; one
    launch per call, b left as it was."""
    F, b = _pcr_inputs(np.random.default_rng(6), shape, axis, solve_axis, dtype, cuda_device)
    b_before = b.clone()
    before = pcr_lines.LAUNCHES
    out = pcr_lines.pcr_apply_lines(F, b, axis)
    torch.cuda.synchronize()
    assert pcr_lines.LAUNCHES == before + 1
    ref = pcr_lines.pcr_apply_lines_plain(F, b, axis)
    assert out.shape == b.shape and out.dtype == dtype and torch.equal(b, b_before)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


# Both 3D benchmark cells' chunks (bm2_dip60 257x25x65, bm3_dip30
# 193x17x49, 8 batches of 5 solves): the sweep's z (clustered), p and r lines.
STEP_CASES = [((8, 5, 257, 25, 65), -3), ((8, 5, 257, 25, 65), -2), ((8, 5, 257, 25, 65), -1),
              ((8, 5, 193, 17, 49), -3), ((8, 5, 193, 17, 49), -2), ((8, 5, 193, 17, 49), -1)]


@pytest.mark.cuda
@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape,axis", STEP_CASES)
def test_pcr_step_epilogue_matches_plain(cuda_device, shape, axis, dtype, tol, in_place):
    """K3 with the step epilogue, base + w x (and w x without base), in place
    over base or into a new tensor: bit for bit K3's x through the torch
    multiply and add on the card, and within the tolerance of K3 of the
    plain version; one launch, counted in FUSED too; b left as it was."""
    F, b = _pcr_inputs(np.random.default_rng(9), shape, axis, True, dtype, cuda_device)
    L = (F.shape[1] - 1) // 2
    if axis == -3:  # the z lines are split over a cluster
        assert pcr_lines.kernel_info(shape[0], shape[1], shape[2:], axis, L, dtype)["cluster"] > 1
    z = torch.randn(b.shape, device=cuda_device, dtype=dtype)
    b_before, z_before, w = b.clone(), z.clone(), 0.6
    x = pcr_lines.pcr_apply_lines(F, b, axis)
    before = pcr_lines.LAUNCHES, pcr_lines.FUSED.LAUNCHES
    got = pcr_lines.pcr_apply_lines(F, b, axis, scale=w, base=z, out=z if in_place else None)
    torch.cuda.synchronize()
    assert (pcr_lines.LAUNCHES, pcr_lines.FUSED.LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, z_before + w * x) and torch.equal(b, b_before)
    assert (got is z) == in_place and (in_place or torch.equal(z, z_before))
    assert torch.equal(pcr_lines.pcr_apply_lines(F, b, axis, scale=w), w * x)
    ref = pcr_lines.pcr_apply_lines_plain(F, b, axis, scale=w, base=z_before)
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


# kernel_info of K3's launch without the step epilogue at the 2D log's finest
# lines (74 batches of 5 solves, and the power iterations' one vector, on
# 761x161), as the instantiation before the epilogue was added reports it on
# an H100: (registers, spill bytes, shared memory per block, blocks per SM).
K3_2D_INFO = {
    ("z", 5, torch.float32): (68, 0, 75328, 3), ("r", 5, torch.float32): (56, 0, 108256, 2),
    ("z", 1, torch.float32): (68, 0, 64288, 3), ("r", 1, torch.float32): (56, 0, 61888, 3),
    ("z", 5, torch.float64): (72, 0, 75328, 3), ("r", 5, torch.float64): (62, 0, 108256, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("d,S,dtype", list(K3_2D_INFO))
def test_pcr_kernel_info_without_the_step_is_unchanged(cuda_device, d, S, dtype):
    """The 2D V-cycle's launches of K3 (no step epilogue) keep their
    registers, spills, shared memory, occupancy and tile plan."""
    axis = {"z": -2, "r": -1}[d]
    L = math.ceil(math.log2(761 if d == "z" else 161))
    info = pcr_lines.kernel_info(74, S, (761, 161), axis, L, dtype)
    outer, n, inner = pcr_lines.line_view((761, 161), axis)
    plan = pcr_lines.tile_plan(74, S, outer, n, inner, L, torch.empty((), dtype=dtype).element_size())
    assert {k: info[k] for k in pcr_lines.PLAN_FIELDS} == plan._asdict()
    got = (info["registers"], info["spill_bytes"], info["smem_bytes"], info["blocks_per_sm"])
    assert got == K3_2D_INFO[(d, S, dtype)]


@pytest.mark.parametrize("device", [pytest.param("cuda", marks=pytest.mark.cuda), "cpu"])
def test_k3_fused_counts_the_sweep_steps(device):
    """A small 3D "adi" log (33x5x17, chunks of 2 batches): every chunk row
    counts the sweep's steps written by K3's epilogue, 5 per application of
    the preconditioner (one before the CG loop, one per iteration; the loop
    graphed on the card); none on the CPU, where the plain version runs, and
    none in a 2D chunk."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = Model.compute_synthetic_logs(
        ["A2.0M0.5N"], np.array([11.5, 12.5, 13.5]), BM3_FORMATION, BM3_BOREHOLE,
        borehole_geometry_type="radius", device=device, batch_size=1, verbose=False, dip=30,
        grid_spec3d=GridSpec3D(nz=33, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2),
        executor_overrides={"precond3d": "adi", "chunk_size_3d": 2})
    chunks = m.last_report["chunks"]
    per_chunk = 5 if device == "cuda" else 0
    assert len(chunks) == 2 and all(c["iterations"] > 0 for c in chunks)
    assert [c["k3_fused"] for c in chunks] == [per_chunk * (c["iterations"] + 1) for c in chunks]
    if device == "cuda":
        assert all(c["replays"] == c["iterations"] - 1 for c in chunks)
        m2 = Model.compute_synthetic_logs(
            ["A2.0M0.5N"], np.array([-0.4, 0.0, 0.6]), BM3_FORMATION, BM3_BOREHOLE,
            borehole_geometry_type="radius", device=device, batch_size=1, verbose=False,
            grid_spec=GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2),
            executor_overrides={"preconditioner": "multigrid", "chunk_size": 2})
        assert m2.last_report["chunks"] and all(
            c["k3_fused"] == 0 for c in m2.last_report["chunks"])


def _longest_line(S, inner, itemsize):
    """The longest line (lines along -2 of an (n, inner) grid) with a plan."""
    lo, hi = 1, 1 << 16
    while hi - lo > 1:
        mid = (lo + hi) // 2
        L = max(1, (mid - 1).bit_length())
        lo, hi = (mid, hi) if pcr_lines.tile_plan(1, S, 1, mid, inner, L, itemsize) else (lo, mid)
    return lo


@pytest.mark.cuda
def test_pcr_kernel_refuses_a_line_beyond_shared_memory(cuda_device):
    """The longest float64 line whose 5 solves have a plan (split over a
    cluster of 8) launches and matches the plain version; one node more is
    refused before any launch (no fallback)."""
    n_max = _longest_line(5, 3, 8)
    assert n_max > pcr_lines.MAX_SMEM_BYTES // (2 * 8 * 5)  # longer than one block holds
    F, b = _pcr_inputs(np.random.default_rng(8), (1, 5, n_max, 3), -2, True, torch.float64,
                       cuda_device)
    L = (F.shape[1] - 1) // 2
    info = pcr_lines.kernel_info(1, 5, (n_max, 3), -2, L, torch.float64)
    assert info["blocks_per_sm"] >= 1 and info["cluster"] == 8
    out = pcr_lines.pcr_apply_lines(F, b, -2)
    ref = pcr_lines.pcr_apply_lines_plain(F, b, -2)
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    F, b = _pcr_inputs(np.random.default_rng(8), (1, 5, n_max + 1, 3), -2, True, torch.float64,
                       cuda_device)
    before = pcr_lines.LAUNCHES
    with pytest.raises(ValueError, match="shared memory"):
        pcr_lines.pcr_apply_lines(F, b, -2)
    assert pcr_lines.LAUNCHES == before


# (n, cluster): lines not a multiple of the cluster, shorter than it (n = 1,
# 2, 3: empty segments), and segments of 1-3 nodes, where every level's
# shift crosses a segment boundary; rows in a cluster of one block.
CLUSTER_CASES = [(1, 4), (2, 4), (3, 4), (3, 8), (5, 2), (13, 8), (17, 8), (24, 8), (97, 4),
                 (193, 2), (1, 1), (17, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n,cluster", CLUSTER_CASES)
def test_pcr_kernel_cluster_edges(cuda_device, n, cluster, dtype, tol):
    """K3 with its lines split over a cluster (a plan given to ``launch``)
    against the plain version: z lines of an (n, 19) grid in tiles of 8
    lines (the last tile 11), 3 solves, each level's neighbours read from
    the other blocks' shared memory."""
    F, b = _pcr_inputs(np.random.default_rng(n), (2, 3, n, 19), -2, True, dtype, cuda_device)
    L = (F.shape[1] - 1) // 2
    plan = pcr_lines.make_plan(3, 1, n, 19, L, b.element_size(), 1, 2, cluster, 2)
    assert plan.cluster == cluster and plan.seg * cluster >= n
    out = torch.empty_like(b)
    pcr_lines.launch(build.load_library(), F, b, out, -2, plan)
    ref = pcr_lines.pcr_apply_lines_plain(F, b, -2)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
def test_pcr_kernel_refuses_a_plan_it_cannot_run(cuda_device):
    """The C side checks the plan and refuses, not repairs: a segment too
    short for the line, a cluster above 8, shared memory that does not match
    the plan, a tile of part of inner across outer lines."""
    F, b = _pcr_inputs(np.random.default_rng(3), (1, 2, 33, 17), -2, True, torch.float32,
                       cuda_device)
    L = (F.shape[1] - 1) // 2
    good = pcr_lines.make_plan(2, 1, 33, 17, L, 4, 1, 2, 4, 2)
    bad = [good._replace(seg=8), good._replace(cluster=16, seg=3),
           good._replace(smem=good.smem + 16), good._replace(stages=1)]
    lib, out = build.load_library(), torch.empty_like(b)
    for plan in bad:
        with pytest.raises(RuntimeError, match="CUDA error"):
            pcr_lines.launch(lib, F, b, out, -2, plan)
    Fr, br = _pcr_inputs(np.random.default_rng(3), (1, 2, 6, 33, 17), -2, True, torch.float32,
                         cuda_device)
    wide = pcr_lines.make_plan(2, 6, 33, 17, L, 4, 3, 2, 1, 2)  # TO = 2 with TI < inner
    with pytest.raises(RuntimeError, match="CUDA error"):
        pcr_lines.launch(lib, Fr, br, torch.empty_like(br), -2, wide)
    pcr_lines.launch(lib, F, b, out, -2, good)
    assert torch.allclose(out, pcr_lines.pcr_apply_lines_plain(F, b, -2), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", [((74, 5, 97, 33), -2), ((8, 5, 49, 9, 17), -3),
                                        ((8, 5, 49, 9, 17), -2), ((8, 5, 49, 9, 17), -1)])
def test_pcr_kernel_in_a_cuda_graph_is_bit_equal(cuda_device, shape, axis):
    """K3 captured into a CUDA graph (after an uncaptured launch of the shape,
    as pcg's first iteration is) and replayed gives bit for bit the op-by-op
    result: clustered (z) and whole-line plans; the launch counts in
    CAPTURED."""
    F, b = _pcr_inputs(np.random.default_rng(4), shape, axis, True, torch.float32, cuda_device)
    eager = pcr_lines.pcr_apply_lines(F, b, axis)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = pcr_lines.CAPTURED
    with torch.cuda.graph(graph):
        out = pcr_lines.pcr_apply_lines(F, b, axis)
    assert pcr_lines.CAPTURED == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    b.mul_(2)
    graph.replay()
    again = pcr_lines.pcr_apply_lines(F, b, axis)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_small_graphed_logs_with_k3_on_and_off(cuda_device, dim):
    """A small float32 log (2D 97x33 multigrid, 3D 49x9x17 ADI; the CG loop
    graphed) with K3 and with ``lines.PCR_KERNEL`` off: readouts within the
    logs' gates (2e-4 in 2D, 1e-3 in 3D), CG iterations per chunk within 1,
    K3 launched in every chunk with it on and never with it off."""
    tools = ["A2.0M0.5N", "B5.7A0.4M"]
    if dim == 2:
        depths, rel = np.array([-0.4, 0.0, 0.6]), 2e-4
        kw = dict(grid_spec=GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2),
                  executor_overrides={"preconditioner": "multigrid", "chunk_size": 2})
    else:
        depths, rel = np.array([11.5, 12.5, 13.5]), 1e-3
        kw = dict(dip=30, grid_spec3d=GridSpec3D(nz=49, np_=9, nr=17, n_wall_cells=3,
                                                  n_blend_cells=2),
                  executor_overrides={"precond3d": "adi", "chunk_size_3d": 2})
    runs = {}
    for on in (True, False):
        lines.PCR_KERNEL = on
        try:
            before = pcr_lines.LAUNCHES
            m = Model.compute_synthetic_logs(
                tools, depths, BM3_FORMATION, BM3_BOREHOLE, borehole_geometry_type="radius",
                device="cuda", batch_size=1, verbose=False, **kw)
            runs[on] = (m, pcr_lines.LAUNCHES - before)
        finally:
            lines.PCR_KERNEL = True
    (m_on, n_on), (m_off, n_off) = runs[True], runs[False]
    it_on = [c["iterations"] for c in m_on.last_report["chunks"]]
    it_off = [c["iterations"] for c in m_off.last_report["chunks"]]
    assert n_off == 0 and n_on >= sum(it_on) and len(it_on) >= 2
    assert all(abs(a - b) <= 1 for a, b in zip(it_on, it_off))
    for t in tools:
        on, off = m_on.logs[t][:, 1], m_off.logs[t][:, 1]
        assert np.isfinite(on).all() and np.abs(on / off - 1).max() <= rel


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device):
    """A preconditioner that reads the device from the host cannot be
    captured: pcg raises, and does not run the loop op by op instead."""
    C = torch.as_tensor(random_symmetric_stencil_2d(np.random.default_rng(2), 1, 17, 9),
                        device=cuda_device)
    C[..., 1, 1] += 4.0
    b = torch.ones((1, 2, 17, 9), device=cuda_device, dtype=C.dtype)
    with pytest.raises(RuntimeError, match="captur"):
        cg.pcg(C, b, M_inv=lambda r: r / float(r.abs().max()), tol=1e-12, maxiter=50)


@pytest.mark.cuda
def test_stalled_launch_is_cut(cuda_device):
    """A launch that hangs the card (a ~10-minute ``torch.cuda._sleep``, then
    the sync that waits for it) is cut by chip_smoke's runner at its limit and
    reported as cut, within 20 s of the limit. The limit is 20 s, not less, so
    that the child reaches the card (~8 s for a process's start) and queues
    the launch before it is cut."""
    code = ("import torch; torch.cuda._sleep(int(600 * 2e9)); print('launched', flush=True); "
            "torch.cuda.synchronize(); print('{}')")
    run = run_child([sys.executable, "-c", code], 20, echo=False)
    assert run["status"] == "cut", run
    assert "launched" in run["tail"] and run["seconds"] < 20 + 20
