# -*- coding: utf-8 -*-
"""The 3D block-direct solvers of the port (``ops/block_direct3d.py``,
``ops/block_bcr3d.py``, ``runtime._solve_chunk_3d`` with ``precond="direct"``)
against the JAX functions they replace, on the CPU.

Inputs are random symmetric diagonally-dominant 27-point stencils from numpy
seeds at the sizes of tests/test_block_direct.py (NZ 6-7, NP 3, NR 4), and the
two 33x5x17 dipping grids of tests/test_torch_ops3d.py for the chunk solve.
Tolerances: a factor agrees with JAX's within 1e-4 of max|G| in float32 and
1e-10 in float64; an apply within 1e-5 / 1e-12 of max|x| and leaves a residual
of at most 3e-5 of max|b| (float32); the chunk solve has JAX's iteration count
within 1 and its axis potentials within 1e-4 of their magnitude (two CG runs
stopped at tol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remo3d_tpu.ops import block_bcr3d as jbcr3
from remo3d_tpu.ops import block_direct3d as jbd3
from remo3d_tpu.parallel import runtime as jrt
from remo3d_tpu_torch.convert import factors_to_numpy, factors_to_torch
from remo3d_tpu_torch.ops import block_bcr3d as tbcr3
from remo3d_tpu_torch.ops import block_direct3d as tbd3
from remo3d_tpu_torch.ops.cg import pcg
from remo3d_tpu_torch.ops.stencil3d import entry_index, pole_project, stencil3d_apply
from remo3d_tpu_torch.parallel import runtime as trt

from .test_pallas import _random_symmetric_stencil
from .test_torch_block_direct import assert_factors_close, leaves
from .test_torch_ops3d import make_problem

torch.set_num_threads(2)
CPU = jax.devices("cpu")[0]
NP, NR = 3, 4
DTYPES = [("float32", 1e-4, 1e-5), ("float64", 1e-10, 1e-12)]
FACTORS = {
    "scan": (lambda C, dt: jbd3.block_thomas_factor_3d(C, NP, NR, store_dtype=dt),
             lambda C: tbd3.block_thomas_factor_3d(C, NP, NR)),
    # z_block 4 does not divide NZ: the ragged last group
    "fp": (lambda C, dt: jbd3.schur_fixedpoint_factor_3d(C, NP, NR, passes=3, z_block=4,
                                                         store_dtype=dt),
           lambda C: tbd3.schur_fixedpoint_factor_3d(C, NP, NR, passes=3, z_block=4)),
    "bcr": (lambda C, dt: jbcr3.bcr_factor_3d(C, NP, NR, z_block=2, store_dtype=dt),
            lambda C: tbcr3.bcr_factor_3d(C, NP, NR, z_block=2)),
}


@pytest.fixture(autouse=True, scope="module")
def x64():
    """float64 on the JAX side, for this file only."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


def spd_stencil(seed, B, NZ, dtype="float32", boost=8.0):
    rng = np.random.default_rng(seed)
    C = np.array(_random_symmetric_stencil(rng, B, NZ, NP, NR)).astype(dtype)
    C[..., entry_index(0, 0, 0)] += boost  # diagonal dominance -> SPD
    return C


def apply_port(schedule, F, C, b):
    if schedule == "bcr":
        return tbcr3.bcr_apply_3d(F, b, NP, NR)
    return tbd3.block_thomas_apply_3d(F, C, b, NP, NR)


def apply_jax(schedule, F, C, b):
    if schedule == "bcr":
        return jbcr3.bcr_apply_3d(F, b, NP, NR)
    return jbd3.block_thomas_apply_3d(F, C, b, NP, NR)


@pytest.mark.parametrize("NZ", [6, 7])
@pytest.mark.parametrize("dtype,tol_factor,tol_apply", DTYPES)
@pytest.mark.parametrize("schedule", ["scan", "fp", "bcr"])
def test_factor_and_apply_match_jax(schedule, dtype, tol_factor, tol_apply, NZ):
    """Each factor against JAX's at both NZ parities, then each apply on the
    port's own factor with b of both ranks against JAX's apply on JAX's."""
    B, S = 2, 2
    C = spd_stencil(NZ, B, NZ, dtype)
    b = np.random.default_rng(NZ + 100).standard_normal((B, S, NZ, NP, NR)).astype(dtype)
    j_factor, t_factor = FACTORS[schedule]
    with jax.default_device(CPU):
        F_j = j_factor(jnp.asarray(C), jnp.dtype(dtype))
        x_j = [np.asarray(apply_jax(schedule, F_j, jnp.asarray(C), jnp.asarray(bb)))
               for bb in (b, b[:, 0])]
    C_t = torch.as_tensor(C)
    F_t = t_factor(C_t)
    assert_factors_close(F_t, F_j, tol_factor)
    for bb, ref in zip((b, b[:, 0]), x_j):
        x_t = apply_port(schedule, F_t, C_t, torch.as_tensor(bb)).numpy()
        assert x_t.shape == ref.shape and x_t.dtype == ref.dtype
        assert float(np.abs(x_t - ref).max()) <= tol_apply * float(np.abs(ref).max())


@pytest.mark.parametrize("shape", [(2, 2, 6), (2, 6), (2, 2, 7), (1, 7)])
@pytest.mark.parametrize("schedule", ["scan", "bcr"])
def test_exact_factor_is_an_inverse(schedule, shape):
    """float32: A·apply(b) - b is at most 3e-5 of max|b|, with and without the
    solve axis, and PCG with the apply converges in at most 4 iterations."""
    B, NZ = shape[0], shape[-1]
    C = torch.as_tensor(spd_stencil(sum(shape), B, NZ, boost=15.0))
    b = torch.as_tensor(
        np.random.default_rng(9).standard_normal(shape + (NP, NR)).astype(np.float32))
    F = FACTORS[schedule][1](C)
    x = apply_port(schedule, F, C, b)
    assert float((stencil3d_apply(C, x) - b).abs().max()) <= 3e-5 * float(b.abs().max())
    _, info = pcg(None, b, M_inv=lambda r: apply_port(schedule, F, C, r), tol=1e-7, maxiter=50,
                  n_grid_axes=3, matvec=lambda p: stencil3d_apply(C, p))
    assert info["iterations"] <= 4 and float(info["rel_residual"].max()) <= 1e-6


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("schedule", ["scan", "bcr"])
def test_factor_crosses_packages(schedule, direction):
    """A factor made by one package, carried over by ``convert.py``, applied by
    the other: the result is the inverse (residual <= 3e-5 of max|b|)."""
    B, S, NZ = 2, 2, 7
    C = spd_stencil(17, B, NZ, boost=15.0)
    b = np.random.default_rng(18).standard_normal((B, S, NZ, NP, NR)).astype(np.float32)
    C_t, b_t = torch.as_tensor(C), torch.as_tensor(b)
    with jax.default_device(CPU):
        if direction == "jax_to_port":
            F_j = FACTORS[schedule][0](jnp.asarray(C), jnp.float32)
            F = factors_to_torch(jax.tree_util.tree_map(np.asarray, F_j), "cpu", torch.float32)
            x = apply_port(schedule, F, C_t, b_t)
        else:
            F = jax.tree_util.tree_map(jnp.asarray, factors_to_numpy(FACTORS[schedule][1](C_t)))
            x = torch.tensor(np.array(apply_jax(schedule, F, jnp.asarray(C), jnp.asarray(b))))
    assert float((stencil3d_apply(C_t, x) - b_t).abs().max()) <= 3e-5 * float(b_t.abs().max())


@pytest.mark.parametrize("schedule", ["scan", "fp", "bcr"])
def test_padded_batch_contract(schedule):
    """An all-zero (padded) batch factors to the identity: finite everywhere,
    and exactly 0 on the padded batch for a zero load there."""
    B, S, NZ = 2, 2, 7
    C = spd_stencil(8, B, NZ)
    C[1] = 0.0
    b = np.zeros((B, S, NZ, NP, NR), dtype=np.float32)
    b[0] = np.random.default_rng(9).standard_normal((S, NZ, NP, NR))
    C_t = torch.as_tensor(C)
    F = FACTORS[schedule][1](C_t)
    assert all(np.isfinite(leaf).all() for leaf in leaves(factors_to_numpy(F)))
    for bb in (b, b[:, 0]):
        x = apply_port(schedule, F, C_t, torch.as_tensor(bb))
        assert torch.isfinite(x).all() and float(x[1].abs().max()) == 0.0


def test_fixedpoint_converges_to_exact_factor():
    """At passes >= NZ the fixed point is the exact chain (1e-5 absolute); at
    0, 2 and 4 passes it is SPD and PCG converges in at most 8 iterations."""
    B, S, NZ = 1, 2, 7
    C = torch.as_tensor(spd_stencil(12, B, NZ))
    b = torch.as_tensor(
        np.random.default_rng(13).standard_normal((B, S, NZ, NP, NR)).astype(np.float32))
    G_exact = tbd3.block_thomas_factor_3d(C, NP, NR)
    G_full = tbd3.schur_fixedpoint_factor_3d(C, NP, NR, passes=NZ, z_block=3)
    assert float((G_full - G_exact).abs().max()) <= 1e-5
    for passes in (0, 2, 4):
        G = tbd3.schur_fixedpoint_factor_3d(C, NP, NR, passes=passes, z_block=4)
        assert torch.equal(G, G.transpose(-1, -2))
        assert float(torch.linalg.eigvalsh(G.double()).min()) > 0
        _, info = pcg(None, b, M_inv=lambda r: tbd3.block_thomas_apply_3d(G, C, r, NP, NR),
                      tol=1e-7, maxiter=50, n_grid_axes=3, matvec=lambda p: stencil3d_apply(C, p))
        assert info["iterations"] <= 8 and float(info["rel_residual"].max()) <= 1e-6


def test_banded_helpers_match_dense_products():
    """The shifted-diagonal products against the dense matrices they stand for,
    on a plane with NR = 2, where two in-plane offsets share a flat offset."""
    np_, nr = 3, 2
    npr = np_ * nr
    rng = np.random.default_rng(4)
    coefs = [torch.as_tensor(rng.standard_normal((2, npr))) for _ in range(9)]
    M = torch.as_tensor(rng.standard_normal((2, npr, npr)))
    v = torch.as_tensor(rng.standard_normal((2, npr)))
    L = tbd3._dense_block(coefs, np_, nr, promote_diag=False)
    for (dp, dr), c in zip(tbd3._PLANE_OFFS, coefs):  # entry by entry
        for k in range(npr):
            p, r = divmod(k, nr)
            if 0 <= p + dp < np_ and 0 <= r + dr < nr:
                same = [c2[:, k] for (dp2, dr2), c2 in zip(tbd3._PLANE_OFFS, coefs)
                        if dp2 * nr + dr2 == dp * nr + dr
                        and 0 <= p + dp2 < np_ and 0 <= r + dr2 < nr]
                assert torch.allclose(L[:, k, k + dp * nr + dr], sum(same))
    assert torch.allclose(tbd3._banded_matmul_left(coefs, M, np_, nr), L @ M)
    assert torch.allclose(tbd3._banded_matmul_right(M, coefs, np_, nr), M @ L)
    assert torch.allclose(tbd3._banded_matvec(coefs, v, np_, nr), (L @ v[..., None])[..., 0])
    LT = tbd3._dense_block(tbd3._transpose_coefs(coefs, nr), np_, nr, promote_diag=False)
    assert torch.allclose(LT, L.transpose(-1, -2))


@pytest.fixture(scope="module")
def problem():
    return make_problem()


@pytest.mark.parametrize("schedule,passes", [("scan", None), ("bcr", None), ("fp", 4)])
def test_solve_chunk_3d_direct_matches_jax(problem, schedule, passes):
    """The whole 3D chunk solve with the direct preconditioner on the two
    dipping grids: JAX's iteration count within 1 (a tenth of the count for
    the truncated fixed point), the axis potentials within 1e-4 of their
    magnitude, the empty solve slot converged at once."""
    keys = ("coords", "sigma", "free", "src_i", "src_fac")
    kw = dict(tol=1e-5, maxiter=400, precond="direct", metric="cylindrical", schedule=schedule,
              factor_passes=passes)
    with jax.default_device(CPU):
        args_j = [jnp.asarray(problem[k].astype(np.int32) if k == "src_i" else problem[k])
                  for k in keys]
        ua_j, rel_j, it_j = jrt._solve_chunk_3d(*args_j, **kw)
    timings = {}
    ua_t, rel_t, it_t = trt._solve_chunk_3d(*[torch.as_tensor(problem[k]) for k in keys],
                                            use_kernel=True, timings=timings, **kw)
    assert timings["factor"]() > 0
    assert 0 < it_t < 400 and abs(it_t - int(it_j)) <= max(1, int(it_j) // 10)
    assert (it_t <= 6) == (schedule != "fp")
    assert float(rel_t.max()) <= 1e-5 and float(rel_t[1, 2]) == 0.0
    ref = np.asarray(ua_j)
    np.testing.assert_allclose(ua_t.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("schedule", ["scan", "bcr"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_direct_3d_routing(problem, monkeypatch, use_kernel, schedule):
    """With ``use_kernel`` the direct solve's matvec is the half-storage wrapper
    with the pole tie (one call per CG iteration) and the boundary lift one call
    without it; the plain 27-point apply is not called. The preconditioner
    projects before and after its apply: 2 ``pole_project`` calls per
    application, one more on the load."""
    calls, plain, poles = [], [], []
    real_half, real_plain = trt.stencil3d_apply_half, trt.stencil3d_apply
    real_pole = trt.pole_project

    def half(C_half, u, pole=False):
        calls.append(pole)
        return real_half(C_half, u, pole=pole)

    monkeypatch.setattr(trt, "stencil3d_apply_half", half)
    monkeypatch.setattr(trt, "stencil3d_apply",
                        lambda C, u: plain.append(1) or real_plain(C, u))
    monkeypatch.setattr(trt, "pole_project", lambda u: poles.append(1) or real_pole(u))
    keys = ("coords", "sigma", "free", "src_i", "src_fac")
    _, rel, iters = trt._solve_chunk_3d(
        *[torch.as_tensor(problem[k]) for k in keys], tol=1e-5, maxiter=400, precond="direct",
        metric="cylindrical", schedule=schedule, use_kernel=use_kernel)
    assert float(rel.max()) <= 1e-5 and 0 < iters <= 6
    if use_kernel:
        assert calls == [False] + [True] * iters and plain == []
        assert len(poles) == 1 + 2 * (iters + 1)
    else:
        assert calls == [] and len(plain) == 1 + iters
        assert len(poles) == 1 + 2 * (iters + 1) + 2 * iters


def test_pole_tied_direct_preconditioner_is_symmetric():
    """P·apply(P·r) on the tied subspace: <M r1, r2> = <r1, M r2> to float64
    rounding, for both applies."""
    B, S, NZ = 1, 1, 6
    C = torch.as_tensor(spd_stencil(21, B, NZ, "float64"))
    rng = np.random.default_rng(22)
    r1, r2 = (torch.as_tensor(rng.standard_normal((B, S, NZ, NP, NR))) for _ in range(2))
    for schedule in ("scan", "bcr"):
        F = FACTORS[schedule][1](C)
        M = lambda r: pole_project(apply_port(schedule, F, C, pole_project(r)))  # noqa: E731
        a, b = float((M(r1) * r2).sum()), float((r1 * M(r2)).sum())
        assert abs(a - b) <= 1e-12 * abs(a)
