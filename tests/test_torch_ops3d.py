# -*- coding: utf-8 -*-
"""Operator-level parity of the 3D slice: each port op against the JAX function
it replaces, on a 33x5x17 dipping-layer grid (2 batches x 3 solves, CPU,
float32).

The grids come from the numpy ``build_grid3d`` (bit-equal in both packages,
tests/test_torch_host.py); random right-hand sides from numpy seeds.
Tolerances: float32 rounding, rtol 1e-5 with an absolute floor of 1e-5 of the
reference's largest magnitude (the ROADMAP operator gate); the preconditioned
CG composes hundreds of such ops and is held to 1e-5 of its solution's
magnitude with the iteration count within 2%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remo3d_tpu.ops import assembly3d as jasm
from remo3d_tpu.ops import lines3d as jlines
from remo3d_tpu.ops import stencil3d as jst
from remo3d_tpu.parallel.runtime import _pcg3 as j_pcg3
from remo3d_tpu.parallel.runtime import _solve_chunk_3d as j_solve_chunk_3d
from remo3d_tpu_torch.meshing.carve import carve_local_model
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D, build_grid3d
from remo3d_tpu_torch.ops import assembly3d as tasm
from remo3d_tpu_torch.ops import lines3d as tlines
from remo3d_tpu_torch.ops import stencil3d as tst
from remo3d_tpu_torch.parallel.runtime import _pcg3 as t_pcg3
from remo3d_tpu_torch.parallel.runtime import _solve_chunk_3d as t_solve_chunk_3d

torch.set_num_threads(2)
CPU = jax.devices("cpu")[0]
SPEC = GridSpec3D(nz=33, np_=5, nr=17, n_wall_cells=3, n_blend_cells=2)
FORMATION = np.array([
    [-100.0, -1.0, np.nan, np.nan, 10.0],
    [-1.0, 1.0, 0.4, 5.0, 100.0],
    [1.0, 100.0, np.nan, np.nan, 10.0],
])
BOREHOLE = np.array([[-100.0, 0.1, 1.0], [100.0, 0.1, 1.0]])
METRICS = ["cartesian", "cylindrical"]


def close(port, ref, rtol=1e-5):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * float(np.max(np.abs(ref))))


def make_problem():
    """Two batch grids (dips 0.3 and 0.5 rad, other centres) with 3 solves each
    (one empty slot), as numpy float32."""
    grids = []
    for center, dip in ((0.2, 0.3), (-0.4, 0.5)):
        lm = carve_local_model(FORMATION, BOREHOLE, 1.0, center, 50.0, dip_rad=dip)
        grids.append(build_grid3d(SPEC, 50.0, lm, dip, np.array([-2.0, 0.0, 2.0]) + center,
                                  np.array([0.0, 2.0]) + center))
    rng = np.random.default_rng(21)
    coords = np.stack([g.coords for g in grids]).astype(np.float32)
    sigma = np.stack([g.sigma_cells for g in grids]).astype(np.float32)
    free = np.stack([g.free_mask for g in grids])
    src_i = rng.integers(3, SPEC.nz - 3, size=(2, 3, 2))
    src_z = np.take_along_axis(coords[:, None, :, 0, 0, 2], src_i, axis=-1).astype(np.float32)
    src_fac = rng.choice([-1.0, 1.0], size=(2, 3, 2)).astype(np.float32)
    src_fac[1, 2] = 0.0
    return {"coords": coords, "sigma": sigma, "free": free, "src_i": src_i, "src_z": src_z,
            "src_fac": src_fac, "sigma0": sigma[:, 0, 0, 0].copy()}


@pytest.fixture(scope="module")
def problem():
    return make_problem()


def _jax(a):
    return jnp.asarray(a)


@pytest.fixture(scope="module")
def stencils(problem):
    """The assembled (eliminated, cylindrical) stencil from each package."""
    with jax.default_device(CPU):
        C_j = jasm.assemble_stencil_3d(_jax(problem["coords"]), _jax(problem["sigma"]),
                                       _jax(problem["free"]), metric="cylindrical")
    C_t = tasm.assemble_stencil_3d(torch.as_tensor(problem["coords"]),
                                   torch.as_tensor(problem["sigma"]),
                                   torch.as_tensor(problem["free"]), metric="cylindrical")
    return C_j, C_t


@pytest.mark.parametrize("metric", METRICS)
def test_element_matrices_fold_and_dirichlet_match_jax(problem, metric):
    coords_t, sigma_t = torch.as_tensor(problem["coords"]), torch.as_tensor(problem["sigma"])
    nz, np_, nr = SPEC.nz, SPEC.np_, SPEC.nr
    with jax.default_device(CPU):
        K_j = jasm.element_matrices_3d(_jax(problem["coords"]), _jax(problem["sigma"]),
                                       metric=metric)
        C_raw_j = jasm.fold_to_stencil_3d(K_j, nz, np_, nr)
        C_j = jasm.apply_dirichlet_3d(C_raw_j, _jax(problem["free"]))
    K_t = tasm.element_matrices_3d(coords_t, sigma_t, metric=metric)
    for a in range(8):
        for b in range(8):
            close(K_t[a][b], K_j[a][b])
    C_raw_t = tasm.fold_to_stencil_3d(K_t, nz, np_, nr)
    close(C_raw_t, C_raw_j)
    close(tasm.apply_dirichlet_3d(C_raw_t, torch.as_tensor(problem["free"])), C_j)


@pytest.mark.parametrize("metric", METRICS)
def test_singularity_load_matches_jax(problem, metric):
    args = [problem[k] for k in ("coords", "sigma", "sigma0", "src_z", "src_fac")]
    with jax.default_device(CPU):
        c, s, s0, z, f = (_jax(a) for a in args)
        u_s_j = jasm.fundamental_potential_3d(c, s0, z, f)
        rhs_j = jasm.singularity_rhs_3d(c, s, s0, z, f, metric=metric)
    c, s, s0, z, f = (torch.as_tensor(a) for a in args)
    close(tasm.fundamental_potential_3d(c, s0, z, f), u_s_j)
    close(tasm.singularity_rhs_3d(c, s, s0, z, f, metric=metric), rhs_j)


@pytest.mark.parametrize("solve_axis", [False, True])
def test_stencil3d_apply_matches_jax(stencils, solve_axis):
    C_j, C_t = stencils
    rng = np.random.default_rng(3)
    shape = (2, 3, SPEC.nz, SPEC.np_, SPEC.nr) if solve_axis else (2, SPEC.nz, SPEC.np_, SPEC.nr)
    u = rng.standard_normal(shape).astype(np.float32)
    with jax.default_device(CPU):
        ref = jst.stencil3d_apply(C_j, _jax(u))
    close(tst.stencil3d_apply(C_t, torch.as_tensor(u)), ref)
    np.testing.assert_array_equal(tst.stencil3d_diag(C_t).numpy(), np.asarray(jst.stencil3d_diag(C_j)))


def test_pole_project_matches_jax():
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 3, 7, 5, 4)).astype(np.float32)
    with jax.default_device(CPU):
        ref = np.asarray(jst.pole_project(_jax(u)))
    u_t = torch.as_tensor(u)
    out = tst.pole_project(u_t)
    close(out, ref)
    np.testing.assert_array_equal(out[..., 1:].numpy(), u[..., 1:])
    np.testing.assert_array_equal(u_t.numpy(), u)  # the input is left as it was
    close(tst.pole_project(out), ref)  # a projection


@pytest.mark.parametrize("direction", ["z", "p", "r"])
def test_line_factor_and_apply_match_jax(stencils, direction):
    C_j, C_t = stencils
    rng = np.random.default_rng(5)
    b = rng.standard_normal((2, 3, SPEC.nz, SPEC.np_, SPEC.nr)).astype(np.float32)
    with jax.default_device(CPU):
        f_j = jlines.line_factor3(C_j, direction)
        ref = jlines.line_apply3(f_j, _jax(b))
        ref_inline = getattr(jlines, f"line_solve_{direction}3")(C_j, _jax(b))
    f_t = tlines.line_factor3(C_t, direction)
    assert f_t[2] == f_j[2] and len(f_t[0]) == len(f_j[0])
    for (al_t, be_t), (al_j, be_j) in zip(f_t[0], f_j[0]):
        close(al_t, al_j)
        close(be_t, be_j)
    close(f_t[1], f_j[1])
    out = tlines.line_apply3(f_t, torch.as_tensor(b))
    close(out, ref)
    close(getattr(tlines, f"line_solve_{direction}3")(C_t, torch.as_tensor(b)), ref_inline)


@pytest.mark.parametrize("precond", ["adi", "lines"])
def test_pole_tied_line_pcg_matches_jax(stencils, precond):
    """The 3D CG (``_pcg3``) from an axis point load: the same iteration count
    within 2% (float32 rounding over ~200 iterations of the additive "lines"
    sweep moves the stopping point by a few), the axis readout within 1e-5 of
    its magnitude."""
    C_j, C_t = stencils
    b = np.zeros((2, 2, SPEC.nz, SPEC.np_, SPEC.nr), dtype=np.float32)
    b[0, 0, 12, :, 0] = 1.0 / SPEC.np_
    b[1, 1, 20, :, 0] = 1.0 / SPEC.np_
    offset = np.zeros((2, 2, SPEC.nz), dtype=np.float32)
    with jax.default_device(CPU):
        ua_j, rel_j, it_j = j_pcg3(C_j, _jax(b), _jax(offset), tol=1e-5, maxiter=400,
                                   precond=precond)
    ua_t, rel_t, it_t = t_pcg3(C_t, torch.as_tensor(b), torch.as_tensor(offset),
                               lambda u: tst.stencil3d_apply(C_t, u), tol=1e-5, maxiter=400,
                               precond=precond)
    assert 0 < it_t < 400 and abs(it_t - int(it_j)) <= max(1, int(it_j) // 50)
    assert float(rel_t.max()) <= 1e-5
    close(ua_t, ua_j)


@pytest.mark.parametrize("subtract", [True, False])
def test_solve_chunk_3d_matches_jax(problem, subtract):
    """The whole chunk solve (assembly, the singularity-subtracted load with its
    boundary lift, or the plain axis point load; ADI CG; axis readout) on the
    two dipping grids: the iteration count within 2%, the axis potentials
    within 1e-4 of their magnitude (two CG runs stopped at tol 1e-5), the
    empty solve slot converged at once."""
    keys = ("coords", "sigma", "free", "src_i", "src_fac")
    kw = dict(tol=1e-5, maxiter=400, subtract=subtract, precond="adi", metric="cylindrical")
    with jax.default_device(CPU):
        args_j = [_jax(problem[k].astype(np.int32) if k == "src_i" else problem[k]) for k in keys]
        ua_j, rel_j, it_j = j_solve_chunk_3d(*args_j, **kw)
    ua_t, rel_t, it_t = t_solve_chunk_3d(*[torch.as_tensor(problem[k]) for k in keys],
                                         use_kernel=True, **kw)
    assert 0 < it_t < 400 and abs(it_t - int(it_j)) <= max(1, int(it_j) // 50)
    assert float(rel_t.max()) <= 1e-5 and float(rel_t[1, 2]) == 0.0
    close(ua_t, ua_j, rtol=1e-4)
