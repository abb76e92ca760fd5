# -*- coding: utf-8 -*-
"""Operator-level parity: each port op against the JAX function it replaces,
on the 65x17 problem of ``__graft_entry__._tiny_problem`` (CPU, float32).

Tolerances: operator-level ops agree to float32 rounding, rtol 1e-5 (with an
absolute floor of 1e-5 of the reference's largest magnitude, for entries that
cancel to ~0); the V-cycle and PCG compose hundreds of such ops and are held to
1e-5 of the solution's magnitude, with PCG's iteration count exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_problem
from remo3d_tpu.ops import assembly2d as jasm
from remo3d_tpu.ops import cg as jcg
from remo3d_tpu.ops import lines as jlines
from remo3d_tpu.ops import multigrid as jmg
from remo3d_tpu.ops.stencil import stencil_apply as jstencil_apply
from remo3d_tpu_torch.convert import chunk_to_torch, stencil_to_torch
from remo3d_tpu_torch.ops import assembly2d as tasm
from remo3d_tpu_torch.ops import cg as tcg
from remo3d_tpu_torch.ops import lines as tlines
from remo3d_tpu_torch.ops import multigrid as tmg
from remo3d_tpu_torch.ops.stencil import stencil_apply as tstencil_apply

torch.set_num_threads(2)
CPU = jax.devices("cpu")[0]


def close(port, ref, rtol=1e-5):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * float(np.max(np.abs(ref))))


@pytest.fixture(scope="module")
def problem():
    """The tiny 2D problem, 2 batches x 3 solves, as numpy, JAX and torch."""
    arrays = _tiny_problem(n_batches=2, n_solves=3)
    arrays[4][1, 2] = 0.0  # one empty solve slot (b = 0, masked in CG)
    with jax.default_device(CPU):
        j = [jnp.asarray(a) for a in arrays]
        C_j = jasm.assemble_stencil_2d(j[0], j[1], j[2])
    t = chunk_to_torch(arrays, "cpu", torch.float32)
    return {"np": arrays, "jax": j, "torch": t, "C_jax": C_j,
            "C_torch": stencil_to_torch(C_j, "cpu", torch.float32)}


def test_assembly_matches_jax(problem):
    coords_j, sigma_j, free_j, src_i, src_fac = problem["jax"]
    coords_t, sigma_t, free_t, src_i_t, src_fac_t = problem["torch"]
    nz, nr = coords_t.shape[1:3]
    with jax.default_device(CPU):
        K_j = jasm.element_matrices_2d(coords_j, sigma_j)
        C_raw_j = jasm.fold_to_stencil(K_j, nz, nr)
        C_j = jasm.apply_dirichlet(C_raw_j, free_j)
        sigma0_j = sigma_j[:, 0, 0]
        src_z_j = jnp.take_along_axis(coords_j[:, :, 0, 0][:, None, :], src_i, axis=-1)
        u_s_j = jasm.fundamental_potential_2d(coords_j, sigma0_j, src_z_j, src_fac)
        rhs_j = jasm.singularity_rhs_2d(coords_j, sigma_j, sigma0_j, src_z_j, src_fac)
    K_t = tasm.element_matrices_2d(coords_t, sigma_t)
    for a in range(4):
        for b in range(4):
            close(K_t[a][b], K_j[a][b])
    C_raw_t = tasm.fold_to_stencil(K_t, nz, nr)
    close(C_raw_t, C_raw_j)
    close(tasm.apply_dirichlet(C_raw_t, free_t), C_j)
    close(tasm.assemble_stencil_2d(coords_t, sigma_t, free_t), problem["C_jax"])
    sigma0_t = sigma_t[:, 0, 0]
    src_z_t = torch.tensor(np.asarray(src_z_j))
    close(tasm.fundamental_potential_2d(coords_t, sigma0_t, src_z_t, src_fac_t), u_s_j)
    close(tasm.singularity_rhs_2d(coords_t, sigma_t, sigma0_t, src_z_t, src_fac_t), rhs_j)


@pytest.mark.parametrize("solve_axis", [False, True])
def test_stencil_apply_matches_jax(problem, solve_axis):
    rng = np.random.default_rng(3)
    shape = (2, 3, 65, 17) if solve_axis else (2, 65, 17)
    u = rng.standard_normal(shape).astype(np.float32)
    with jax.default_device(CPU):
        ref = jstencil_apply(problem["C_jax"], jnp.asarray(u))
    close(tstencil_apply(problem["C_torch"], torch.as_tensor(u)), ref)


@pytest.mark.parametrize("direction", ["r", "z"])
def test_pcr_and_line_apply_match_jax(problem, direction):
    rng = np.random.default_rng(4)
    b = rng.standard_normal((2, 3, 65, 17)).astype(np.float32)
    C_j, C_t = problem["C_jax"], problem["C_torch"]
    (lo, mid, hi), axis = tlines._LINE_AXES_2D[direction]
    with jax.default_device(CPU):
        steps_j, dinv_j = jlines.pcr_factor(
            C_j[..., lo[0], lo[1]], C_j[..., mid[0], mid[1]], C_j[..., hi[0], hi[1]], axis=axis
        )
        f_j = jlines.line_factor_2d(C_j, direction)
        ref = jlines.line_apply_2d(f_j, jnp.asarray(b))
        b0 = jnp.asarray(b[:, 0])
        ref_pcr = jlines.pcr_apply(steps_j, dinv_j, b0, axis=axis)
    steps_t, dinv_t = tlines.pcr_factor(
        C_t[..., lo[0], lo[1]], C_t[..., mid[0], mid[1]], C_t[..., hi[0], hi[1]], axis=axis
    )
    assert len(steps_t) == len(steps_j)
    for (al_t, be_t), (al_j, be_j) in zip(steps_t, steps_j):
        close(al_t, al_j)
        close(be_t, be_j)
    close(dinv_t, dinv_j)
    close(tlines.pcr_apply(steps_t, dinv_t, torch.as_tensor(b[:, 0]), axis=axis), ref_pcr)
    f_t = tlines.line_factor_2d(C_t, direction)
    out_t = tlines.line_apply_2d(f_t, torch.as_tensor(b))
    close(out_t, ref)
    # Factored PCR is the in-line PCR algebra (the JAX CPU path's smoother).
    solve = tlines.line_solve_r if direction == "r" else tlines.line_solve_z
    close(solve(C_t, torch.as_tensor(b)), out_t.numpy())


def test_prolong_restrict_galerkin_match_jax(problem):
    rng = np.random.default_rng(5)
    zc = rng.standard_normal((2, 3, 33, 9)).astype(np.float32)
    r = rng.standard_normal((2, 3, 65, 17)).astype(np.float32)
    free_c = np.asarray(problem["np"][2])[:, ::2, ::2]
    with jax.default_device(CPU):
        p_j = jmg.prolong(jnp.asarray(zc))
        r_j = jmg.restrict(jnp.asarray(r))
        CH_j = jmg.galerkin_coarsen(problem["C_jax"], jnp.asarray(free_c))
    close(tmg.prolong(torch.as_tensor(zc)), p_j)
    close(tmg.restrict(torch.as_tensor(r)), r_j)
    close(tmg.galerkin_coarsen(problem["C_torch"], torch.as_tensor(free_c)), CH_j)


@pytest.fixture(scope="module")
def hierarchies(problem):
    """Both packages' 4-level hierarchies with the production smoother knobs
    (Chebyshev degree 2, 6 power iterations, line_rz)."""
    cfg_j = jmg.MGConfig(n_levels=4, degree_pre=2, degree_post=2, power_iters=6)
    cfg_t = tmg.MGConfig(n_levels=4, degree_pre=2, degree_post=2, power_iters=6,
                         kernel_levels=2)
    coords_j, sigma_j, free_j = problem["jax"][:3]
    coords_t, sigma_t, free_t = problem["torch"][:3]
    with jax.default_device(CPU):
        lev_j = jmg.build_hierarchy(coords_j, sigma_j, free_j, cfg_j)
    lev_t = tmg.build_hierarchy(coords_t, sigma_t, free_t, cfg_t)
    return (lev_j, cfg_j), (lev_t, cfg_t)


def test_v_cycle_matches_jax(problem, hierarchies):
    (lev_j, cfg_j), (lev_t, cfg_t) = hierarchies
    for l_j, l_t in zip(lev_j, lev_t):
        close(l_t["C"], l_j["C"])
        close(l_t["lmax"], l_j["lmax"])
    rng = np.random.default_rng(6)
    r = rng.standard_normal((2, 3, 65, 17)).astype(np.float32)
    r *= np.asarray(problem["np"][2])[:, None]
    with jax.default_device(CPU):
        ref = jmg.v_cycle(lev_j, jnp.asarray(r), cfg_j)
    close(tmg.v_cycle(lev_t, torch.as_tensor(r), cfg_t), ref)


def test_pcg_matches_jax(problem, hierarchies):
    """Multigrid PCG from the singularity-free point-source load: identical
    iteration count, solution within 1e-5 of its magnitude; the empty solve
    slot stays inactive and zero."""
    src_i, src_fac = problem["np"][3], problem["np"][4]
    b = np.zeros((2, 3, 65, 17), dtype=np.float32)
    for bi in range(2):
        for si in range(3):
            b[bi, si, src_i[bi, si, 0], 0] += src_fac[bi, si, 0]
    (lev_j, cfg_j), (lev_t, cfg_t) = hierarchies
    with jax.default_device(CPU):
        u_j, info_j = jcg.pcg(
            lev_j[0]["C"], jnp.asarray(b), M_inv=lambda r: jmg.v_cycle(lev_j, r, cfg_j),
            tol=1e-6, maxiter=200,
        )
    u_t, info_t = tcg.pcg(
        lev_t[0]["C"], torch.as_tensor(b), M_inv=lambda r: tmg.v_cycle(lev_t, r, cfg_t),
        tol=1e-6, maxiter=200, matvec=tmg.make_stencil_apply(lev_t[0]["C"], True),
    )
    assert info_t["iterations"] == int(info_j["iterations"])
    assert 0 < info_t["iterations"] < 200
    close(u_t, u_j)
    close(info_t["rel_residual"], info_j["rel_residual"], rtol=1e-2)
    assert float(u_t[1, 2].abs().max()) == 0.0
    # Jacobi ("local") PCG, the default M_inv: ~480 float32 iterations carry
    # order-dependent rounding, so the count may differ by one and the
    # solutions agree to the 1e-5 tolerance the loop stops at, not to rounding.
    with jax.default_device(CPU):
        u_jj, info_jj = jcg.pcg(problem["C_jax"], jnp.asarray(b), tol=1e-5, maxiter=3000)
    u_tj, info_tj = tcg.pcg(problem["C_torch"], torch.as_tensor(b), tol=1e-5, maxiter=3000)
    assert abs(info_tj["iterations"] - int(info_jj["iterations"])) <= 1
    close(u_tj, u_jj, rtol=1e-4)
