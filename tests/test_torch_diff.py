# -*- coding: utf-8 -*-
"""The differentiable forward of the port (remo3d_tpu_torch/diff.py, 2D)
against the JAX package's (remo3d_tpu/diff.py), on the CPU.

An inline model: 3 layers, the middle one invaded (4 parameters), two tools, 3
depths on a 97x33 grid. The JAX forward, Jacobian and gradient are computed once
per module. Also here: the kernels' autograd Functions (K1's, the 2D half) and
the linear solve with a custom gradient (ops/linear_solve.py) against dense
torch on tiny systems, and the device default.

float32 throughout, as the JAX package runs it; the float64 checks are
``torch.autograd.gradcheck``'s and the dense solves'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import remo3d_tpu
import remo3d_tpu_torch
from remo3d_tpu import diff as jdiff
from remo3d_tpu.meshing.grid2d import GridSpec2D as JSpec2
from remo3d_tpu_torch import convert
from remo3d_tpu_torch import diff as tdiff
from remo3d_tpu_torch.kernels import stencil2d
from remo3d_tpu_torch.kernels.stencil2d import POS_OFFSETS_2D, _window
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D as TSpec2
from remo3d_tpu_torch.ops.linear_solve import linear_solve, solve_tangents
from remo3d_tpu_torch.ops.stencil import stencil_apply

torch.set_num_threads(2)

FORMATION = np.array([
    [-100.0, 2.0, np.nan, np.nan, 10.0],
    [2.0, 3.0, 0.3, 5.0, 100.0],
    [3.0, 200.0, np.nan, np.nan, 10.0],
])
BOREHOLE = np.array([[-100.0, 0.1, 1.0], [200.0, 0.1, 1.0]])
TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]
DEPTHS = np.array([2.0, 2.5, 3.0])
GRID = dict(nz=97, nr=33, n_wall_cells=6, n_blend_cells=3)
TOL, MAXITER = 3e-7, 1000


def projection_weights(shape):
    return np.random.default_rng(3).standard_normal(shape).astype(np.float32)


def model(pkg):
    m = pkg.Model(TOOLS)
    m.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius")
    return m


@pytest.fixture(scope="module")
def jax_side():
    with jax.default_device(jax.devices("cpu")[0]):
        dlog = jdiff.DifferentiableLog(model(remo3d_tpu), DEPTHS, grid_spec=JSpec2(**GRID),
                                       chunk_size=8)
        p0 = jnp.asarray(dlog.params0)
        forward = np.asarray(dlog.forward(p0))
        J = np.asarray(dlog.jacobian(p0))
        w = jnp.asarray(projection_weights(forward.shape))

        def proj(p):
            out = dlog(p)
            return jnp.sum(jnp.where(jnp.isnan(out), 0.0, out * w))

        grad = np.asarray(jax.jit(jax.grad(proj))(p0))
    return {"dlog": dlog, "forward": forward, "J": J, "grad": grad}


@pytest.fixture(scope="module")
def port():
    return remo3d_tpu_torch.DifferentiableLog(
        model(remo3d_tpu_torch), DEPTHS, grid_spec=TSpec2(**GRID), chunk_size=8, device="cpu")


@pytest.fixture(scope="module")
def port_jacobian(port):
    return port.jacobian(port.params0).numpy()


def port_grad(dlog, w):
    p = torch.tensor(dlog.params0, dtype=torch.float32, requires_grad=True)
    out = dlog(p)
    (g,) = torch.autograd.grad(torch.where(torch.isnan(out), 0.0, out * torch.as_tensor(w)).sum(), p)
    return g.numpy()


# ---- staging -----------------------------------------------------------------------


def test_parameters_match_jax(jax_side, port):
    assert port.param_names == jax_side["dlog"].param_names == ["UZ[0]", "UZ[1]", "UZ[2]", "FZ[1]"]
    np.testing.assert_array_equal(port.params0, jax_side["dlog"].params0)


def test_staging_matches_jax(jax_side, port):
    """Every staged array of every chunk: ints and bools equal, floats bitwise."""
    ref = jax_side["dlog"]._stacked
    assert sorted(port._stacked) == sorted(ref)
    for name, a in ref.items():
        a, b = np.asarray(a), port._stacked[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=name)


def test_chunk_plan_to_torch_types(jax_side):
    t = convert.chunk_plan_to_torch(jax_side["dlog"]._stacked, "cpu")
    assert t["region"].dtype == torch.int64 and t["free"].dtype == torch.bool
    assert t["coords"].dtype == torch.float32 and t["ro_out"].dtype == torch.int64
    np.testing.assert_array_equal(t["coords"].numpy(), np.asarray(jax_side["dlog"]._stacked["coords"]))


def test_solve_chunk_diff_matches_jax(jax_side):
    """One chunk's axis potentials from JAX's staging, through both packages'
    chunk solves: within 1e-5 of max|u|."""
    stacked = jax_side["dlog"]._stacked
    c = {k: v[0] for k, v in convert.chunk_plan_to_torch(stacked, "cpu").items()}
    p = np.asarray(jax_side["dlog"].params0, dtype=np.float32)
    region = np.asarray(stacked["region"][0])
    sigma = np.where(region >= 0, 1.0 / p[np.clip(region, 0, None)],
                     np.asarray(stacked["sigma_fixed"][0])).astype(np.float32)
    args = [stacked[k][0] for k in ("coords",)] + [jnp.asarray(sigma)] + [
        stacked[k][0] for k in ("free", "src_i", "src_fac")]
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jax.jit(
            lambda *a: jdiff._solve_chunk_diff(*a, tol=TOL, maxiter=MAXITER, factor_passes=None)
        )(*args))
    info = {}
    out = tdiff._solve_chunk_diff(c["coords"], torch.as_tensor(sigma), c["free"], c["src_i"],
                                  c["src_fac"], tol=TOL, maxiter=MAXITER, info=info).numpy()
    assert 0 < info["iterations"] < 10
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


# ---- the log, its Jacobian and gradient ------------------------------------------------


def test_forward_matches_jax(jax_side, port):
    out = port.forward(port.params0).numpy()
    assert out.shape == (len(DEPTHS), len(TOOLS)) and np.isfinite(out).all()
    assert np.max(np.abs(out / jax_side["forward"] - 1)) < 1e-4


def test_forward_matches_port_model(port):
    """The port's DifferentiableLog reproduces the port's direct-preconditioned
    Model log on the same grid (the JAX package's bound, 5e-4)."""
    m = model(remo3d_tpu_torch)
    m.simulate_logs(DEPTHS, device="cpu", preconditioner="direct", verbose=False,
                    grid_spec=TSpec2(**GRID), executor_overrides={"chunk_size": 8})
    ref = np.stack([m.logs[t][:, 1] for t in TOOLS], axis=1)
    out = port.forward(port.params0).numpy()
    assert np.max(np.abs(out / ref - 1)) < 5e-4


def test_forward_records_no_graph_and_the_call_does(port):
    """``forward`` takes no tape; the call on a tensor that requires a gradient
    does, with the same values, on the parameters' device."""
    p = torch.tensor(port.params0, dtype=torch.float32, requires_grad=True)
    plain = port.forward(p)
    taped = port(p)
    assert plain.grad_fn is None and taped.grad_fn is not None
    assert taped.device.type == "cpu" and taped.dtype == torch.float32
    torch.testing.assert_close(plain, taped.detach(), rtol=0, atol=0)


def test_jacobian_matches_jax(jax_side, port_jacobian):
    J_ref = jax_side["J"]
    assert port_jacobian.shape == J_ref.shape == (len(DEPTHS), len(TOOLS), 4)
    assert np.abs(port_jacobian - J_ref).max() <= 1e-3 * np.abs(J_ref).max()


def test_grad_matches_jax(jax_side, port):
    g = port_grad(port, projection_weights(jax_side["forward"].shape))
    ref = jax_side["grad"]
    assert np.abs(g - ref).max() <= 1e-3 * np.abs(ref).max()


def test_grad_matches_jacobian_projection(port, port_jacobian):
    """Reverse mode (adjoint solves) against forward mode (tangent solves):
    entirely different paths through the linear solve."""
    w = projection_weights(port_jacobian.shape[:2])
    g = port_grad(port, w)
    g_fwd = np.einsum("mtp,mt->p", port_jacobian, w)
    scale = np.abs(g_fwd).max()
    assert scale > 0
    np.testing.assert_allclose(g, g_fwd, atol=2e-3 * scale, rtol=2e-3)
    info = port.last_report["chunks"][0]
    assert 0 < info["adjoint_iterations"] < 10


def test_jacobian_finite_difference(port, port_jacobian):
    """Central finite differences on the two most sensitive parameters."""
    p0 = np.asarray(port.params0, dtype=np.float64)
    sens = np.abs(port_jacobian).sum(axis=(0, 1))
    for k in np.argsort(sens)[-2:]:
        h = 0.02 * p0[k]
        pp, pm = p0.copy(), p0.copy()
        pp[k] += h
        pm[k] -= h
        fd = (port.forward(pp).numpy() - port.forward(pm).numpy()) / (2 * h)
        scale = np.abs(fd).max()
        assert scale > 0
        np.testing.assert_allclose(port_jacobian[:, :, k], fd, atol=0.05 * scale, rtol=0.05)


@pytest.mark.parametrize("schedule,passes", [("bcr", None), ("fp", 16)])
def test_other_schedules_give_the_same_chunk_solve(port, schedule, passes):
    """The preconditioner carries no gradient: another schedule of the
    factorization changes the CG iteration count, not a chunk's axis
    potentials or their gradient in sigma."""
    c = next(port._chunks())[0]
    p = torch.tensor(port.params0, dtype=torch.float32)
    sigma = port._sigma(c, 1.0 / p).requires_grad_(True)
    out = {}
    for name, fp in (("scan", None), (schedule, passes)):
        info = {}
        u = tdiff._solve_chunk_diff(c["coords"], sigma, c["free"], c["src_i"], c["src_fac"],
                                    tol=TOL, maxiter=MAXITER, schedule=name, factor_passes=fp,
                                    info=info)
        g = torch.as_tensor(np.random.default_rng(5).standard_normal(u.shape), dtype=u.dtype)
        out[name] = (u.detach(), torch.autograd.grad((u * g).sum(), sigma)[0], info)
    (u0, g0, i0), (u1, g1, i1) = out["scan"], out[schedule]
    assert (u0 - u1).abs().max() <= 1e-5 * u0.abs().max()
    assert (g0 - g1).abs().max() <= 1e-4 * g0.abs().max()
    assert i0["iterations"] <= 4 and i1["adjoint_iterations"] > 0


def test_factor_passes_select_fp(port, port_jacobian):
    """A pass count selects the Schur fixed-point factorization, as in the
    JAX package; the log and its Jacobian stay."""
    other = remo3d_tpu_torch.DifferentiableLog(
        model(remo3d_tpu_torch), DEPTHS, grid_spec=TSpec2(**GRID), chunk_size=8, device="cpu",
        factor_passes=16)
    assert port.direct_schedule == "scan" and other.direct_schedule == "fp"
    np.testing.assert_allclose(other.forward(other.params0).numpy(),
                               port.forward(port.params0).numpy(), rtol=2e-5)
    J = other.jacobian(other.params0).numpy()
    assert np.abs(J - port_jacobian).max() <= 1e-4 * np.abs(port_jacobian).max()


def test_device_default_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        remo3d_tpu_torch.DifferentiableLog(model(remo3d_tpu_torch), DEPTHS,
                                           grid_spec=TSpec2(**GRID))


# ---- K1 under autograd ---------------------------------------------------------------


def full_from_half_2d(C_half):
    """The full (B, NZ, NR, 3, 3) stencil of half storage, differentiably: each
    offset plane fills the direct entry at n and the mirrored one at n+d; the
    diagonal is the row sum (plane 0) less the row's couplings."""
    B, _, nz, nr = C_half.shape
    C = C_half.new_zeros((B, nz, nr, 3, 3))
    C[..., 1, 1] = C_half[:, 0]
    for k, (dz, dr) in enumerate(POS_OFFSETS_2D):
        (zd, zs), (rd, rs) = _window(dz, nz), _window(dr, nr)
        C[:, zd, rd, 1 + dz, 1 + dr] = C_half[:, k + 1, zd, rd]
        C[:, zs, rs, 1 - dz, 1 - dr] = C_half[:, k + 1, zd, rd]
        C[:, zd, rd, 1, 1] = C[:, zd, rd, 1, 1] - C_half[:, k + 1, zd, rd]
        C[:, zs, rs, 1, 1] = C[:, zs, rs, 1, 1] - C_half[:, k + 1, zd, rd]
    return C


def random_half_2d(rng, B, nz, nr, dtype=torch.float64):
    C = rng.standard_normal((B, 5, nz, nr))
    C[:, 0] = 10.0 + rng.random((B, nz, nr))
    return torch.as_tensor(C, dtype=dtype)


@pytest.mark.parametrize("shape", [(1, 2, 7, 5), (2, 3, 9, 6)])
def test_function_matches_autograd_of_full_plain_apply(shape):
    """StencilApplyHalf2D's value, grad_u, grad_C_half and jvp against
    autograd of the full 9-point ``stencil_apply`` on the stencil the half
    storage stands for."""
    rng = np.random.default_rng(7)
    C_half = random_half_2d(rng, shape[0], *shape[2:]).requires_grad_(True)
    u = torch.as_tensor(rng.standard_normal(shape)).requires_grad_(True)
    g = torch.as_tensor(rng.standard_normal(shape))
    y = stencil2d.stencil_apply_half_2d(C_half, u)
    y_ref = stencil_apply(full_from_half_2d(C_half), u)
    torch.testing.assert_close(y, y_ref, rtol=1e-13, atol=1e-12)
    assert type(y.grad_fn).__name__ == "StencilApplyHalf2DBackward"
    for a, b in zip(torch.autograd.grad((y * g).sum(), (C_half, u)),
                    torch.autograd.grad((y_ref * g).sum(), (C_half, u))):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    dC, du = torch.randn_like(C_half), torch.randn_like(u)
    _, t = torch.func.jvp(stencil2d.stencil_apply_half_2d, (C_half.detach(), u.detach()), (dC, du))
    _, t_ref = torch.func.jvp(lambda c, x: stencil_apply(full_from_half_2d(c), x),
                              (C_half.detach(), u.detach()), (dC, du))
    torch.testing.assert_close(t, t_ref, rtol=1e-12, atol=1e-12)


def test_function_gradcheck_float64():
    rng = np.random.default_rng(8)
    C_half = random_half_2d(rng, 1, 7, 5).requires_grad_(True)
    u = torch.as_tensor(rng.standard_normal((1, 2, 7, 5))).requires_grad_(True)
    assert torch.autograd.gradcheck(stencil2d.stencil_apply_half_2d, (C_half, u),
                                    check_forward_ad=True, check_backward_ad=True)


# ---- the linear solve with a custom gradient ---------------------------------------------


def dense_2d(C_half):
    """The dense operator of half storage (1, 5, NZ, NR) as a (N, N) matrix,
    differentiable in C_half: the apply on every unit vector."""
    nz, nr = C_half.shape[-2:]
    n = nz * nr
    eye = torch.eye(n, dtype=C_half.dtype).reshape(1, n, nz, nr)
    return stencil2d.stencil_apply_half_2d_plain(C_half, eye).reshape(n, n).T


def test_linear_solve_gradient_matches_dense_solve():
    """w = A^-1 b and the gradients of a projection of w in C_half and b
    against ``torch.linalg.solve`` of the dense operator (float64, CG to
    1e-13, Jacobi-free identity preconditioner)."""
    rng = np.random.default_rng(11)
    nz, nr, S = 6, 5, 3
    C_half = random_half_2d(rng, 1, nz, nr).requires_grad_(True)
    b = torch.as_tensor(rng.standard_normal((1, S, nz, nr))).requires_grad_(True)
    g = torch.as_tensor(rng.standard_normal((1, S, nz, nr)))
    info = {}
    w = linear_solve(C_half, b, lambda r: r, tol=1e-13, maxiter=500, info=info)
    assert type(w.grad_fn).__name__ == "_LinearSolveBackward"  # the CG loop is not on the tape
    w_ref = torch.linalg.solve(dense_2d(C_half), b.reshape(S, -1).T).T.reshape(1, S, nz, nr)
    torch.testing.assert_close(w, w_ref, rtol=1e-10, atol=1e-10)
    grads = torch.autograd.grad((w * g).sum(), (C_half, b))
    refs = torch.autograd.grad((w_ref * g).sum(), (C_half, b))
    for a, r in zip(grads, refs):
        torch.testing.assert_close(a, r, rtol=1e-9, atol=1e-10)
    assert 0 < info["iterations"] and 0 < info["adjoint_iterations"]


def test_solve_tangents_matches_jvp_of_dense_solve():
    """Tangents of w for P directions in one call against ``torch.func.jvp`` of
    the dense solve, one direction at a time."""
    rng = np.random.default_rng(12)
    nz, nr, S, P = 6, 5, 2, 3
    C_half = random_half_2d(rng, 1, nz, nr)
    b = torch.as_tensor(rng.standard_normal((1, S, nz, nr)))
    dC = torch.as_tensor(rng.standard_normal((P, 1, 5, nz, nr)))
    db = torch.as_tensor(rng.standard_normal((P, 1, S, nz, nr)))
    w = linear_solve(C_half, b, lambda r: r, tol=1e-13, maxiter=500)
    info = {}
    dw = solve_tangents(C_half, dC, db, w, lambda r: r, tol=1e-13, maxiter=500, info=info)
    assert dw.shape == (P, 1, S, nz, nr) and info["tangent_iterations"] > 0

    def dense_solve(c, rhs):
        return torch.linalg.solve(dense_2d(c), rhs.reshape(S, -1).T).T.reshape(1, S, nz, nr)

    for k in range(P):
        _, t = torch.func.jvp(dense_solve, (C_half, b), (dC[k], db[k]))
        torch.testing.assert_close(dw[k], t, rtol=1e-9, atol=1e-10)


def test_preconditioner_is_built_without_a_graph(port):
    """The factorization is taken of the detached operator under no_grad:
    its apply returns a tensor outside autograd even for an operator that
    requires a gradient."""
    c = next(port._chunks())[0]
    p = torch.tensor(port.params0, dtype=torch.float32, requires_grad=True)
    C, C_half, rhs, _ = port._system(c, port._sigma(c, 1.0 / p))
    assert C.requires_grad and C_half.requires_grad and rhs.requires_grad
    M_inv = tdiff._preconditioner(C, port.direct_schedule, None)
    assert not M_inv(rhs.detach()).requires_grad
