# -*- coding: utf-8 -*-
"""The 2D block-direct solvers of the port (``ops/block_direct.py``,
``ops/block_bcr.py``, ``runtime._solve_chunk_direct``) against the JAX
functions they replace, on the CPU.

Inputs are random symmetric diagonally-dominant 9-point stencils from numpy
seeds, at the sizes of tests/test_block_direct.py (B 2, S 2-3, NZ 9-31 at both
parities, NR 6-7), and the 65x17 problem of ``__graft_entry__._tiny_problem``
for the chunk solve. Tolerances: a factor agrees with JAX's within 1e-4 of
max|G| in float32 and 1e-10 in float64; an apply within 1e-5 / 1e-12 of max|x|
and leaves a residual of at most 2e-5 of max|b| (float32); the chunk solve has
JAX's iteration count within 1 (a tenth of the count for the fixed point's
~35) and its axis potentials within 1e-5 of their magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_problem
from remo3d_tpu.ops import block_bcr as jbcr
from remo3d_tpu.ops import block_direct as jbd
from remo3d_tpu.parallel import runtime as jrt
from remo3d_tpu_torch.convert import chunk_to_torch, factors_to_numpy, factors_to_torch
from remo3d_tpu_torch.kernels import stencil2d as tk2
from remo3d_tpu_torch.ops import block_bcr as tbcr
from remo3d_tpu_torch.ops import block_direct as tbd
from remo3d_tpu_torch.ops.cg import pcg
from remo3d_tpu_torch.ops.stencil import stencil_apply
from remo3d_tpu_torch.parallel import runtime as trt

from .test_pallas import _random_symmetric_stencil_2d

torch.set_num_threads(2)
CPU = jax.devices("cpu")[0]
DTYPES = [("float32", 1e-4, 1e-5), ("float64", 1e-10, 1e-12)]
FACTORS = {
    "scan": (lambda C, dt: jbd.block_thomas_factor(C, store_dtype=dt), tbd.block_thomas_factor),
    "fp": (lambda C, dt: jbd.schur_fixedpoint_factor(C, passes=3, store_dtype=dt),
           lambda C: tbd.schur_fixedpoint_factor(C, passes=3)),
    "bcr": (lambda C, dt: jbcr.bcr_factor(C, store_dtype=dt), tbcr.bcr_factor),
}


@pytest.fixture(autouse=True, scope="module")
def x64():
    """float64 on the JAX side, for this file only."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


def spd_stencil(seed, B, NZ, NR, dtype="float32", boost=4.0):
    C = _random_symmetric_stencil_2d(np.random.default_rng(seed), B, NZ, NR).astype(dtype)
    C[..., 1, 1] += boost  # diagonal dominance -> SPD
    return C


def leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in leaves(t)]
    return [np.asarray(tree)]


def assert_factors_close(port, ref, tol):
    """Leaf by leaf, within ``tol`` of the largest |G| of the JAX factor."""
    port, ref = leaves(factors_to_numpy(port)), leaves(ref)
    assert [p.shape for p in port] == [r.shape for r in ref]
    scale = max(float(np.abs(r).max()) for r in ref if r.size)
    for p, r in zip(port, ref):
        assert p.dtype == r.dtype
        if r.size:
            assert float(np.abs(p - r).max()) <= tol * scale


def apply_port(schedule, F, C, b):
    return tbcr.bcr_apply(F, b) if schedule == "bcr" else tbd.block_thomas_apply(F, C, b)


def apply_jax(schedule, F, C, b):
    return jbcr.bcr_apply(F, b) if schedule == "bcr" else jbd.block_thomas_apply(F, C, b)


@pytest.mark.parametrize("NZ", [12, 13, 31])
@pytest.mark.parametrize("dtype,tol_factor,tol_apply", DTYPES)
@pytest.mark.parametrize("schedule", ["scan", "fp", "bcr"])
def test_factor_and_apply_match_jax(schedule, dtype, tol_factor, tol_apply, NZ):
    """Each factor against JAX's at both NZ parities, then each apply on the
    port's own factor with b of both ranks against JAX's apply on JAX's."""
    B, S, NR = 2, 3, 7
    C = spd_stencil(NZ, B, NZ, NR, dtype)
    b = np.random.default_rng(NZ + 100).standard_normal((B, S, NZ, NR)).astype(dtype)
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


@pytest.mark.parametrize("shape", [(2, 3, 12, 7), (2, 9, 6), (2, 3, 13, 7), (2, 2, 31, 7)])
@pytest.mark.parametrize("schedule", ["scan", "bcr"])
def test_exact_factor_is_an_inverse(schedule, shape):
    """float32: A·apply(b) - b is at most 2e-5 of max|b|, with and without the
    solve axis, and PCG with the apply converges in at most 4 iterations."""
    B, NZ, NR = shape[0], shape[-2], shape[-1]
    C = torch.as_tensor(spd_stencil(sum(shape), B, NZ, NR))
    b = torch.as_tensor(np.random.default_rng(5).standard_normal(shape).astype(np.float32))
    F = FACTORS[schedule][1](C)
    x = apply_port(schedule, F, C, b)
    assert float((stencil_apply(C, x) - b).abs().max()) <= 2e-5 * float(b.abs().max())
    _, info = pcg(C, b, M_inv=lambda r: apply_port(schedule, F, C, r), tol=1e-7, maxiter=50)
    assert info["iterations"] <= 4 and float(info["rel_residual"].max()) <= 1e-6


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("schedule", ["scan", "bcr"])
def test_factor_crosses_packages(schedule, direction):
    """A factor made by one package, carried over by ``convert.py``, applied by
    the other: the result is the inverse (residual <= 2e-5 of max|b|)."""
    B, S, NZ, NR = 2, 2, 13, 6
    C = spd_stencil(17, B, NZ, NR)
    b = np.random.default_rng(18).standard_normal((B, S, NZ, NR)).astype(np.float32)
    C_t, b_t = torch.as_tensor(C), torch.as_tensor(b)
    with jax.default_device(CPU):
        if direction == "jax_to_port":
            F_j = FACTORS[schedule][0](jnp.asarray(C), jnp.float32)
            F = factors_to_torch(jax.tree_util.tree_map(np.asarray, F_j), "cpu", torch.float32)
            x = apply_port(schedule, F, C_t, b_t)
        else:
            F = jax.tree_util.tree_map(jnp.asarray, factors_to_numpy(FACTORS[schedule][1](C_t)))
            x = torch.tensor(np.array(apply_jax(schedule, F, jnp.asarray(C), jnp.asarray(b))))
    assert float((stencil_apply(C_t, x) - b_t).abs().max()) <= 2e-5 * float(b_t.abs().max())


@pytest.mark.parametrize("schedule", ["scan", "fp", "bcr"])
def test_padded_batch_contract(schedule):
    """An all-zero (padded) batch factors to the identity: finite everywhere,
    and exactly 0 on the padded batch for a zero load there."""
    B, S, NZ, NR = 2, 2, 13, 6
    C = spd_stencil(8, B, NZ, NR, boost=8.0)
    C[1] = 0.0
    b = np.zeros((B, S, NZ, NR), dtype=np.float32)
    b[0] = np.random.default_rng(9).standard_normal((S, NZ, NR))
    C_t = torch.as_tensor(C)
    F = FACTORS[schedule][1](C_t)
    assert all(np.isfinite(leaf).all() for leaf in leaves(factors_to_numpy(F)))
    for bb in (b, b[:, 0]):
        x = apply_port(schedule, F, C_t, torch.as_tensor(bb))
        assert torch.isfinite(x).all() and float(x[1].abs().max()) == 0.0


def test_fixedpoint_converges_to_exact_factor():
    """At passes >= NZ the fixed point is the exact chain (1e-5 absolute, as
    the JAX package's own test); at 0, 2 and 4 passes it is SPD: PCG converges
    in at most 10 iterations and the apply's residual does not grow."""
    B, S, NZ, NR = 2, 3, 14, 7
    C = torch.as_tensor(spd_stencil(11, B, NZ, NR))
    b = torch.as_tensor(
        np.random.default_rng(12).standard_normal((B, S, NZ, NR)).astype(np.float32))
    G_exact = tbd.block_thomas_factor(C)
    assert float((tbd.schur_fixedpoint_factor(C, passes=NZ) - G_exact).abs().max()) <= 1e-5
    prev_err = np.inf
    for passes in (0, 2, 4):
        G = tbd.schur_fixedpoint_factor(C, passes=passes)
        assert torch.equal(G, G.transpose(-1, -2))
        assert float(torch.linalg.eigvalsh(G.double()).min()) > 0
        err = float((stencil_apply(C, tbd.block_thomas_apply(G, C, b)) - b).abs().max())
        assert err < prev_err or err <= 1e-5 * float(b.abs().max())
        prev_err = err
        _, info = pcg(C, b, M_inv=lambda r: tbd.block_thomas_apply(G, C, r), tol=1e-7, maxiter=50)
        assert info["iterations"] <= 10 and float(info["rel_residual"].max()) <= 1e-6


@pytest.mark.parametrize("setting", ["high", "medium"])
def test_matmul_precision_is_restored(setting):
    """The factor and the apply run under "highest" whatever the caller set,
    and the caller's setting is back afterwards, also after an exception."""
    seen = []

    @tbd.highest_matmul_precision
    def probe(fail):
        seen.append(torch.get_float32_matmul_precision())
        if fail:
            raise RuntimeError("probe")

    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(setting)
    try:
        probe(False)
        with pytest.raises(RuntimeError, match="probe"):
            probe(True)
        assert seen == ["highest", "highest"]
        assert torch.get_float32_matmul_precision() == setting
        C = torch.as_tensor(spd_stencil(3, 1, 9, 6))
        tbd.block_thomas_apply(tbd.block_thomas_factor(C), C, torch.ones(1, 9, 6))
        assert torch.get_float32_matmul_precision() == setting
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.fixture(scope="module")
def tiny():
    arrays = _tiny_problem(n_batches=2, n_solves=3)
    arrays[4][1, 2] = 0.0  # one empty solve slot (b = 0, masked in CG)
    return arrays


@pytest.mark.parametrize("subtract", [True, False])
@pytest.mark.parametrize("schedule,passes", [("scan", None), ("bcr", None), ("fp", 6)])
def test_solve_chunk_direct_matches_jax(tiny, schedule, passes, subtract):
    """The 2D direct chunk solve (assembly, factor, load with its lift or the
    plain point load, PCG, axis readout) on the 65x17 problem: JAX's iteration
    count within 1 (the exact factors take 2-4 iterations; the 6-pass fixed
    point takes ~30, held to a tenth of the count), the axis potentials within
    1e-5 of their magnitude. The fixed point's count is compared in float64
    (26 in both packages) within a tenth; in float32 it follows the rounding
    of the operator and of the CG's sums (JAX takes 35 on its own operator,
    the port 29 on its operator, whose diagonal closes the zero row sums,
    ``ops/assembly2d.py``), so there it is held to at most JAX's count plus a
    tenth."""
    kw = dict(tol=1e-7, maxiter=200, subtract=subtract, schedule=schedule, factor_passes=passes)
    with jax.default_device(CPU):
        ua_j, rel_j, it_j = jrt._solve_chunk_direct(*[jnp.asarray(a) for a in tiny], **kw)
    ua_t, rel_t, it_t = trt._solve_chunk_direct(
        *chunk_to_torch(tiny, "cpu", torch.float32), use_kernel=True, **kw)
    slack = max(1, int(it_j) // 10)
    assert 0 < it_t < 200 and it_t <= int(it_j) + slack
    if schedule == "fp":
        arrays = [a.astype(np.float64) if a.dtype == np.float32 else a for a in tiny]
        with jax.default_device(CPU):
            _, _, it_j = jrt._solve_chunk_direct(*[jnp.asarray(a) for a in arrays], **kw)
        _, _, it_t64 = trt._solve_chunk_direct(
            *chunk_to_torch(arrays, "cpu", torch.float64), use_kernel=True, **kw)
        assert abs(it_t64 - int(it_j)) <= max(1, int(it_j) // 10)
    else:
        assert abs(it_t - int(it_j)) <= slack
    assert (it_t <= 4) == (schedule != "fp")
    assert float(rel_t.max()) <= 1e-6 and float(rel_t[1, 2]) == 0.0
    ref = np.asarray(ua_j)
    np.testing.assert_allclose(ua_t.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_solve_chunk_direct_float64(tiny):
    """float64, exact chain: axis potentials within 1e-10 of JAX's."""
    kw = dict(tol=1e-12, maxiter=200, schedule="scan")
    arrays = [a.astype(np.float64) if a.dtype == np.float32 else a for a in tiny]
    with jax.default_device(CPU):
        ua_j, _, _ = jrt._solve_chunk_direct(*[jnp.asarray(a) for a in arrays], **kw)
    ua_t, rel_t, it_t = trt._solve_chunk_direct(
        *chunk_to_torch(arrays, "cpu", torch.float64), use_kernel=True, **kw)
    assert ua_t.dtype == torch.float64 and 0 < it_t <= 4 and float(rel_t.max()) <= 1e-12
    ref = np.asarray(ua_j)
    np.testing.assert_allclose(ua_t.numpy(), ref, rtol=1e-10, atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("use_kernel", [True, False])
def test_direct_matvec_routing(tiny, monkeypatch, use_kernel):
    """With ``use_kernel`` every CG matvec of the direct solve is one call of
    the half-storage wrapper (the kernel on a CUDA tensor); without, none."""
    calls = []
    real = tk2.stencil_apply_half_2d
    # The operator factory binds the wrapper by name in ops/multigrid.py.
    from remo3d_tpu_torch.ops import multigrid as tmg

    def counted(C_half, u):
        calls.append(tuple(u.shape))
        return real(C_half, u)

    monkeypatch.setattr(tmg, "stencil_apply_half_2d", counted)
    timings = {}
    _, _, iters = trt._solve_chunk_direct(
        *chunk_to_torch(tiny, "cpu", torch.float32), tol=1e-7, maxiter=200,
        use_kernel=use_kernel, schedule="bcr", timings=timings)
    assert timings["factor"]() > 0
    if use_kernel:
        assert len(calls) == iters and set(calls) == {(2, 3, 65, 17)}
    else:
        assert calls == []
