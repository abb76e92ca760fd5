# -*- coding: utf-8 -*-
"""The differentiable forward of the port in 3D (remo3d_tpu_torch/diff.py, a
dipping layer) against the JAX package's (remo3d_tpu/diff.py), on the CPU.

tests/test_diff.py's dipping invaded bed (dip 30, 4 parameters) on its 33x5x17
grid. The JAX forward and Jacobian are computed once per module; ``jax.grad``
is not (it costs twice the Jacobian here): the port's reverse mode is held
against the port's own Jacobian, and that Jacobian against JAX's. Also here:
K2's autograd Function with and without the pole tie, and the rejection of a
sigma blend that is not linear in the conductivities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import remo3d_tpu
import remo3d_tpu_torch
from remo3d_tpu import diff as jdiff
from remo3d_tpu.meshing.grid3d import GridSpec3D as JSpec3
from remo3d_tpu_torch import convert
from remo3d_tpu_torch import diff as tdiff
from remo3d_tpu_torch.kernels import stencil3d
from remo3d_tpu_torch.kernels.stencil3d import HALF_ENTRIES, POS_OFFSETS, _window
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D as TSpec3
from remo3d_tpu_torch.ops.stencil3d import entry_index, pole_project, stencil3d_apply

torch.set_num_threads(2)

FORMATION = np.array([
    [-1000.0, 1.0, np.nan, np.nan, 10.0],
    [1.0, 2.2, 0.4, 5.0, 100.0],
    [2.2, 1000.0, np.nan, np.nan, 10.0],
])
BOREHOLE = np.array([[-1000.0, 0.1, 1.0], [1000.0, 0.1, 1.0]])
TOOLS = ["A0.4M0.1N"]
DEPTHS = np.array([1.2, 1.6, 2.0])
GRID = dict(nz=33, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2)
TOL, MAXITER = 3e-7, 1000


def model(pkg):
    m = pkg.Model(TOOLS)
    m.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius", dip=30)
    return m


@pytest.fixture(scope="module")
def jax_side():
    with jax.default_device(jax.devices("cpu")[0]):
        dlog = jdiff.DifferentiableLog(model(remo3d_tpu), DEPTHS, grid_spec3d=JSpec3(**GRID),
                                       domain_radius=10.0, chunk_size=4)
        p0 = jnp.asarray(dlog.params0)
        return {"dlog": dlog, "forward": np.asarray(dlog.forward(p0)),
                "J": np.asarray(dlog.jacobian(p0))}


@pytest.fixture(scope="module")
def port():
    return remo3d_tpu_torch.DifferentiableLog(
        model(remo3d_tpu_torch), DEPTHS, grid_spec3d=TSpec3(**GRID), domain_radius=10.0,
        chunk_size=4, device="cpu")


@pytest.fixture(scope="module")
def port_jacobian(port):
    return port.jacobian(port.params0).numpy()


def test_staging_matches_jax(jax_side, port):
    """Every staged array (the blend weights, the UZ map, the FZ cells, the
    fixed mask and the readout rows included): ints and bools equal, floats
    bitwise."""
    assert port.param_names == jax_side["dlog"].param_names
    np.testing.assert_array_equal(port.params0, jax_side["dlog"].params0)
    ref = jax_side["dlog"]._stacked
    assert sorted(port._stacked) == sorted(ref)
    for name, a in ref.items():
        a, b = np.asarray(a), port._stacked[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=name)


def test_solve_chunk_diff_3d_matches_jax(jax_side):
    """One chunk's axis potentials from JAX's staging through both packages'
    3D chunk solves (the sigma of the JAX package's blend): within 1e-5 of
    max|u|."""
    dlog = jax_side["dlog"]
    stacked = {k: np.asarray(v)[0] for k, v in dlog._stacked.items()}
    p = np.asarray(dlog.params0, dtype=np.float32)
    sig = 1.0 / p
    sigma_w = np.einsum("bzprl,bl->bzpr", stacked["weights"], sig[stacked["uz_map"]])
    fz = stacked["fz_cell"]
    sigma = np.where(stacked["fixed"], stacked["sigma_fixed"],
                     np.where(fz >= 0, sig[np.clip(fz, 0, None)], sigma_w)).astype(np.float32)
    args = [stacked["coords"], sigma, stacked["free"], stacked["src_i"], stacked["src_fac"]]
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jax.jit(lambda *a: jdiff._solve_chunk_diff_3d(
            *a, tol=TOL, maxiter=MAXITER, factor_passes=None, metric=dlog.metric3d))(*args))
    c = {k: v[0] for k, v in convert.chunk_plan_to_torch(dlog._stacked, "cpu").items()}
    info = {}
    out = tdiff._solve_chunk_diff_3d(
        c["coords"], torch.as_tensor(sigma), c["free"], c["src_i"], c["src_fac"], tol=TOL,
        maxiter=MAXITER, metric=dlog.metric3d, info=info).numpy()
    assert 0 < info["iterations"] < 10
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_forward_matches_jax(jax_side, port):
    out = port.forward(port.params0).numpy()
    assert out.shape == (len(DEPTHS), 1) and np.isfinite(out).all()
    assert np.max(np.abs(out / jax_side["forward"] - 1)) < 1e-4


def test_forward_matches_port_model(port):
    """The port's DifferentiableLog reproduces the port's
    ``precond3d="direct"`` Model log on the same grid (same hex assembly,
    pole-tied solve, 0.5 half-space readout; the JAX package's bound)."""
    m = model(remo3d_tpu_torch)
    m.simulate_logs(DEPTHS, domain_radius=10.0, device="cpu", verbose=False,
                    grid_spec3d=TSpec3(**GRID), executor_overrides={"precond3d": "direct"})
    out = port.forward(port.params0).numpy()[:, 0]
    assert np.max(np.abs(out / m.logs[TOOLS[0]][:, 1] - 1)) < 1e-4


def test_jacobian_matches_jax(jax_side, port_jacobian):
    J_ref = jax_side["J"]
    assert port_jacobian.shape == J_ref.shape == (len(DEPTHS), 1, 4)
    assert np.abs(port_jacobian - J_ref).max() <= 1e-3 * np.abs(J_ref).max()


def test_grad_matches_jacobian_projection(port, port_jacobian):
    """Reverse mode (adjoint solves on the pole-tied operator, the lift's
    product through K2's Function) against forward mode."""
    w = np.random.default_rng(3).standard_normal(port_jacobian.shape[:2]).astype(np.float32)
    p = torch.tensor(port.params0, dtype=torch.float32, requires_grad=True)
    (g,) = torch.autograd.grad((port(p) * torch.as_tensor(w)).sum(), p)
    g_fwd = np.einsum("mtp,mt->p", port_jacobian, w)
    scale = np.abs(g_fwd).max()
    assert scale > 0
    np.testing.assert_allclose(g.numpy(), g_fwd, atol=2e-3 * scale, rtol=2e-3)


def test_jacobian_finite_difference(port, port_jacobian):
    """Central finite differences on the shoulder UZ and the invaded bed's FZ
    (through the arithmetic sub-cell weights)."""
    p0 = np.asarray(port.params0, dtype=np.float64)
    for k in (0, 3):
        h = 0.02 * p0[k]
        pp, pm = p0.copy(), p0.copy()
        pp[k] += h
        pm[k] -= h
        fd = (port.forward(pp).numpy() - port.forward(pm).numpy())[:, 0] / (2 * h)
        scale = np.abs(fd).max()
        assert scale > 0
        np.testing.assert_allclose(port_jacobian[:, 0, k], fd, atol=0.01 * scale, rtol=0.01)


def test_rejects_nonlinear_sigma_blend():
    """The harmonic/mixed sub-cell blends are nonlinear in sigma: the
    differentiable path rejects them instead of silently mistracing."""
    with pytest.raises(ValueError, match="arithmetic"):
        remo3d_tpu_torch.DifferentiableLog(
            model(remo3d_tpu_torch), DEPTHS, grid_spec3d=TSpec3(**GRID, sigma_blend="mixed"),
            domain_radius=10.0, device="cpu")


# ---- K2 under autograd ---------------------------------------------------------------


def full_from_half_3d(C_half):
    """The full (B, NZ, NP, NR, 27) stencil of half storage, differentiably."""
    B, _, nz, np_, nr = C_half.shape
    C = C_half.new_zeros((B, nz, np_, nr, 27))
    C[..., HALF_ENTRIES[0]] = C_half[:, 0]
    for k, (dz, dp, dr) in enumerate(POS_OFFSETS):
        (zd, zs), (pd, ps), (rd, rs) = _window(dz, nz), _window(dp, np_), _window(dr, nr)
        C[:, zd, pd, rd, entry_index(dz, dp, dr)] = C_half[:, k + 1, zd, pd, rd]
        C[:, zs, ps, rs, entry_index(-dz, -dp, -dr)] = C_half[:, k + 1, zd, pd, rd]
    return C


def random_half_3d(rng, B, nz, np_, nr):
    C = rng.standard_normal((B, 14, nz, np_, nr))
    C[:, 0] = 30.0 + rng.random((B, nz, np_, nr))
    return torch.as_tensor(C)


@pytest.mark.parametrize("pole", [False, True])
def test_function_matches_autograd_of_full_plain_apply(pole):
    """StencilApplyHalf3D's value, grad_u, grad_C_half and jvp against
    autograd of the full 27-point ``stencil3d_apply`` (between two
    ``pole_project`` calls with the pole tie)."""
    rng = np.random.default_rng(13)
    shape = (2, 3, 5, 4, 6)
    C_half = random_half_3d(rng, 2, *shape[2:]).requires_grad_(True)
    u = torch.as_tensor(rng.standard_normal(shape)).requires_grad_(True)
    g = torch.as_tensor(rng.standard_normal(shape))

    def ref_apply(c, x):
        C = full_from_half_3d(c)
        return pole_project(stencil3d_apply(C, pole_project(x))) if pole else stencil3d_apply(C, x)

    def apply_(c, x):
        return stencil3d.stencil3d_apply_half(c, x, pole)

    y, y_ref = apply_(C_half, u), ref_apply(C_half, u)
    torch.testing.assert_close(y, y_ref, rtol=1e-13, atol=1e-12)
    assert type(y.grad_fn).__name__ == "StencilApplyHalf3DBackward"
    for a, b in zip(torch.autograd.grad((y * g).sum(), (C_half, u)),
                    torch.autograd.grad((y_ref * g).sum(), (C_half, u))):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    dC, du = torch.randn_like(C_half), torch.randn_like(u)
    _, t = torch.func.jvp(apply_, (C_half.detach(), u.detach()), (dC, du))
    _, t_ref = torch.func.jvp(ref_apply, (C_half.detach(), u.detach()), (dC, du))
    torch.testing.assert_close(t, t_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pole", [False, True])
def test_function_gradcheck_float64(pole):
    rng = np.random.default_rng(14)
    C_half = random_half_3d(rng, 1, 4, 3, 4).requires_grad_(True)
    u = torch.as_tensor(rng.standard_normal((1, 2, 4, 3, 4))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda c, x: stencil3d.stencil3d_apply_half(c, x, pole),
                                    (C_half, u), check_forward_ad=True)
