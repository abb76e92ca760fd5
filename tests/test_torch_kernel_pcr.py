# -*- coding: utf-8 -*-
"""Kernel K3 (factored PCR tridiagonal line apply) on the CPU.

The factorization's stacked tensor is bit-equal to the per-level list it
replaced; the port's pcr_apply, line_apply_2d and line_apply3 (the plain
version) match the JAX package's on numpy inputs from a seed, along every
axis, with and without the solve axis, at float32 rounding (1e-6 relative to
max|x|: the same operations in the same order, XLA may contract a
multiply-add) and at 1e-12 in float64; the wrapper takes the plain version on
the CPU, counts nothing there, and refuses what the kernel cannot take. Lines
of 9, 17, 33 and 49 nodes. The kernel itself runs on the card only:
tests/test_torch_cuda.py.
"""

import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remo3d_tpu.ops import lines as jlines
from remo3d_tpu.ops import lines3d as jlines3
from remo3d_tpu_torch import kernels
from remo3d_tpu_torch.kernels import build, pcr_lines
from remo3d_tpu_torch.ops import lines as tlines
from remo3d_tpu_torch.ops import lines3d as tlines3
from remo3d_tpu_torch.ops.stencil3d import entry_index

torch.set_num_threads(2)
CPU = jax.devices("cpu")[0]
TOL = {"float32": 1e-6, "float64": 1e-12}
GRID_2D = (33, 17)  # (NZ, NR)
GRID_3D = (17, 9, 49)  # (NZ, NP, NR)
CASES = [(2, "r"), (2, "z"), (3, "z"), (3, "p"), (3, "r")]


@pytest.fixture
def x64():
    """JAX in float64 for the test (restored after it)."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


def _stencil(dim: int, B: int = 2, seed: int = 3) -> np.ndarray:
    """A random diagonally dominant stencil: (B, NZ, NR, 3, 3) in 2D, (B, NZ,
    NP, NR, 27) in 3D, float64; negative couplings, diagonal their sum plus a
    margin (an M-matrix, as the FEM operators' lines are)."""
    rng = np.random.default_rng(seed)
    grid = GRID_2D if dim == 2 else GRID_3D
    E = 9 if dim == 2 else 27
    C = -rng.uniform(0.1, 1.0, (B, *grid, E))
    centre = 4 if dim == 2 else entry_index(0, 0, 0)
    C[..., centre] = 0.0
    C[..., centre] = -C.sum(-1) + rng.uniform(0.05, 0.5, (B, *grid))
    return C.reshape(B, *grid, 3, 3) if dim == 2 else C


def _factor(dim, direction, C):
    return (tlines.line_factor_2d if dim == 2 else tlines3.line_factor3)(C, direction)


def _per_level_list(dl, d, du, axis, max_steps=None):
    """The factorization as the port computed it before the levels were
    stacked: a list of (alpha, beta) per level, then dinv."""
    a, c = dl, du
    out = []
    s = 1
    for _ in range(tlines._n_steps(d.shape[axis], max_steps)):
        alpha = -a / tlines._safe(tlines._shift(d, s, axis, 1.0))
        beta = -c / tlines._safe(tlines._shift(d, -s, axis, 1.0))
        a_m, c_m = tlines._shift(a, s, axis, 0.0), tlines._shift(c, s, axis, 0.0)
        a_p, c_p = tlines._shift(a, -s, axis, 0.0), tlines._shift(c, -s, axis, 0.0)
        a = alpha * a_m
        c = beta * c_p
        d = d + alpha * c_m + beta * a_p
        out.append((alpha, beta))
        s *= 2
    return out, 1.0 / tlines._safe(d)


def _diagonals(dim, direction, C):
    if dim == 2:
        (lo, mid, hi), axis = tlines._LINE_AXES_2D[direction]
        return [C[..., i, j] for i, j in (lo, mid, hi)], axis
    lo, hi, axis = tlines3._LINE_AXES[direction]
    return [C[..., entry_index(*o)] for o in (lo, (0, 0, 0), hi)], axis


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim,direction", CASES)
def test_stacked_factors_bit_equal_to_per_level_list(dim, direction, dtype):
    """F is contiguous, (B, 2L+1, *grid); its planes are alpha_k, beta_k, then
    dinv, bit for bit the per-level list; steps and dinv are views into F."""
    C = torch.as_tensor(_stencil(dim)).to(dtype)
    axis, F = _factor(dim, direction, C)
    steps, dinv = tlines.split_factors(F, -3 if dim == 2 else -4)
    (dl, d, du), axis_ref = _diagonals(dim, direction, C)
    ref_steps, ref_dinv = _per_level_list(dl, d, du, axis_ref)
    L = len(ref_steps)
    assert axis == axis_ref and L == tlines._n_steps(d.shape[axis], None)
    assert F.is_contiguous() and F.dtype == dtype
    assert tuple(F.shape) == (C.shape[0], 2 * L + 1, *d.shape[1:])
    for k, ((al, be), (al_r, be_r)) in enumerate(zip(steps, ref_steps)):
        assert torch.equal(al, al_r) and torch.equal(be, be_r)
        assert torch.equal(F[:, 2 * k], al_r) and torch.equal(F[:, 2 * k + 1], be_r)
    assert torch.equal(dinv, ref_dinv) and torch.equal(F[:, 2 * L], ref_dinv)
    lo, hi = F.data_ptr(), F.data_ptr() + F.numel() * F.element_size()
    for t in [dinv, *(p for pair in steps for p in pair)]:
        assert lo <= t.data_ptr() < hi  # a view into F, no copy
    # pcr_factor keeps its (steps, dinv) structure: the same planes.
    steps_p, dinv_p = tlines.pcr_factor(dl, d, du, axis=axis)
    assert len(steps_p) == L and torch.equal(dinv_p, ref_dinv)
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(steps_p, ref_steps))


def test_truncated_factorization_has_max_steps_levels():
    C = torch.as_tensor(_stencil(2))
    axis, F = tlines.line_factor_2d(C, "z", max_steps=2)
    steps, dinv = tlines.split_factors(F, -3)
    (dl, d, du), axis = _diagonals(2, "z", C)
    ref_steps, ref_dinv = _per_level_list(dl, d, du, axis, max_steps=2)
    assert F.shape[1] == 5 and len(steps) == 2 and torch.equal(dinv, ref_dinv)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 3, *GRID_2D)))
    assert torch.equal(pcr_lines.pcr_apply_lines(F, b, axis),
                       tlines.pcr_apply([(a.unsqueeze(1), c.unsqueeze(1)) for a, c in ref_steps],
                                        ref_dinv.unsqueeze(1), b, axis=axis))


def _jax_apply(dim, direction, C, b):
    with jax.default_device(CPU):
        C_j = jnp.asarray(C)
        if dim == 2:
            return np.asarray(jlines.line_apply_2d(jlines.line_factor_2d(C_j, direction),
                                                   jnp.asarray(b)))
        return np.asarray(jlines3.line_apply3(jlines3.line_factor3(C_j, direction),
                                              jnp.asarray(b)))


def _parity(dim, direction, solve_axis, np_dtype, tol):
    C = _stencil(dim).astype(np_dtype)
    grid = GRID_2D if dim == 2 else GRID_3D
    b = np.random.default_rng(7).standard_normal((2, 3, *grid) if solve_axis else (2, *grid))
    b = b.astype(np_dtype)
    ref = _jax_apply(dim, direction, C, b)
    assert ref.dtype == np_dtype
    C_t, b_t = torch.as_tensor(C), torch.as_tensor(b)
    factors = _factor(dim, direction, C_t)
    axis, F = factors
    steps, dinv = tlines.split_factors(F, -3 if dim == 2 else -4)
    scale = np.abs(ref).max()
    apply_ = tlines.line_apply_2d if dim == 2 else tlines3.line_apply3
    outs = {"line_apply": apply_(factors, b_t), "wrapper": pcr_lines.pcr_apply_lines(F, b_t, axis)}
    if solve_axis:
        outs["pcr_apply"] = tlines.pcr_apply([(a.unsqueeze(1), c.unsqueeze(1)) for a, c in steps],
                                             dinv.unsqueeze(1), b_t, axis=axis)
    else:
        outs["pcr_apply"] = tlines.pcr_apply(steps, dinv, b_t, axis=axis)
    for name, out in outs.items():
        assert out.dtype == C_t.dtype and tuple(out.shape) == b.shape
        err = np.abs(out.numpy() - ref).max() / scale
        assert err <= tol, f"{name}: {err:.3e}"


@pytest.mark.parametrize("solve_axis", [False, True])
@pytest.mark.parametrize("dim,direction", CASES)
def test_line_apply_matches_jax_float32(dim, direction, solve_axis):
    _parity(dim, direction, solve_axis, np.float32, TOL["float32"])


@pytest.mark.parametrize("solve_axis", [False, True])
@pytest.mark.parametrize("dim,direction", CASES)
def test_line_apply_matches_jax_float64(x64, dim, direction, solve_axis):
    _parity(dim, direction, solve_axis, np.float64, TOL["float64"])


@pytest.mark.parametrize("n", [9, 17, 33, 49])
def test_pcr_apply_solves_the_lines(n):
    """Full PCR is the exact tridiagonal solve, along each of 3 axes, checked
    against a dense solve in float64."""
    rng = np.random.default_rng(n)
    for axis in (-1, -2, -3):
        shape = [2, 3, 5, 4]
        shape[axis] = n
        dl = -rng.uniform(0.1, 1.0, shape)
        du = -rng.uniform(0.1, 1.0, shape)
        d = -(dl + du) + rng.uniform(0.05, 0.5, shape)
        b = rng.standard_normal(shape)
        F = tlines.pcr_factor_stacked(*(torch.as_tensor(a) for a in (dl, d, du)), axis=axis,
                                      stack_dim=1)
        x = pcr_lines.pcr_apply_lines(F, torch.as_tensor(b), axis).numpy()
        lines = [np.moveaxis(a, axis, -1).reshape(-1, n) for a in (dl, d, du, b, x)]
        for lo, di, up, rhs, sol in zip(*lines):
            T = np.diag(di) + np.diag(lo[1:], -1) + np.diag(up[:-1], 1)
            np.testing.assert_allclose(sol, np.linalg.solve(T, rhs), rtol=1e-10, atol=1e-12)


def test_line_view():
    assert pcr_lines.line_view((761, 161), -1) == (761, 161, 1)
    assert pcr_lines.line_view((761, 161), -2) == (1, 761, 161)
    assert pcr_lines.line_view((193, 17, 49), -3) == (1, 193, 17 * 49)
    assert pcr_lines.line_view((193, 17, 49), -2) == (193, 17, 49)
    assert pcr_lines.line_view((193, 17, 49), -1) == (193 * 17, 49, 1)


def test_wrapper_on_cpu_uses_plain_and_counts_nothing():
    """On CPU tensors: the plain version, bit-equal to line_apply's, no build
    and no count; the module counts its launches through kernels.COUNTED."""
    assert pcr_lines in kernels.COUNTED
    before = (pcr_lines.LAUNCHES, pcr_lines.CAPTURED)
    C = torch.as_tensor(_stencil(3)).float()
    factors = tlines3.line_factor3(C, "p")
    b = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 3, *GRID_3D))).float()
    with mock.patch.object(build, "load_library", side_effect=AssertionError("no build on CPU")):
        out = pcr_lines.pcr_apply_lines(factors[1], b, factors[0])
        ref = tlines3.line_apply3(factors, b)
    assert torch.equal(out, ref)
    assert (pcr_lines.LAUNCHES, pcr_lines.CAPTURED) == before


def test_wrapper_raises_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel or raises: a failed
    build propagates, and what the kernel cannot take is refused, with no
    plain fallback and no count."""
    F = torch.empty((2, 11, 33, 17), device="meta")
    b = torch.empty((2, 3, 33, 17), device="meta")
    before = pcr_lines.LAUNCHES
    with mock.patch.object(
        build, "load_library", side_effect=build.BuildError("nvcc failed (mocked)")
    ), mock.patch.object(
        pcr_lines, "pcr_apply_lines_plain", side_effect=AssertionError("fell back")
    ):
        with pytest.raises(build.BuildError, match="mocked"):
            pcr_lines.pcr_apply_lines(F, b, -2)
    with mock.patch.object(build, "load_library", return_value=object()):
        with pytest.raises(ValueError, match="CUDA"):
            pcr_lines.pcr_apply_lines(F, b, -2)
        with pytest.raises(ValueError, match="contiguous"):
            strided = torch.empty((2, 3, 17, 33), device="meta").transpose(2, 3)
            pcr_lines.pcr_apply_lines(F, strided, -2)
        with pytest.raises(ValueError, match="float32 or float64"):
            pcr_lines.pcr_apply_lines(F.half(), b.half(), -2)
        with pytest.raises(ValueError, match="float32 or float64"):
            pcr_lines.pcr_apply_lines(F.double(), b.float(), -2)
        with pytest.raises(ValueError, match="2L\\+1"):
            pcr_lines.pcr_apply_lines(F[:, :10], b, -2)
        with pytest.raises(ValueError, match="axis"):
            pcr_lines.pcr_apply_lines(F, b, -3)
        with pytest.raises(ValueError, match="neither"):
            pcr_lines.pcr_apply_lines(F, b[:, :, :, :9], -2)
        with pytest.raises(ValueError, match="neither"):
            pcr_lines.pcr_apply_lines(F, b[:1], -2)
    assert pcr_lines.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_refuses_a_line_beyond_shared_memory(dtype):
    """A line of all S solves, twice, must fit in a block's shared memory: the
    longest that fits passes every check (and then needs a CUDA tensor), one
    node more, or one solve more, is refused."""
    S, size = 5, torch.empty((), dtype=dtype).element_size()
    n_max = pcr_lines.MAX_SMEM_BYTES // (2 * size * S)

    def apply_(S, n):
        F = torch.empty((1, 3, n, 2), dtype=dtype, device="meta")
        return pcr_lines.pcr_apply_lines(F, torch.empty((1, S, n, 2), dtype=dtype,
                                                        device="meta"), -2)

    before = pcr_lines.LAUNCHES
    with mock.patch.object(build, "load_library", return_value=object()):
        with pytest.raises(ValueError, match="CUDA tensors"):
            apply_(S, n_max)
        with pytest.raises(ValueError, match="shared memory"):
            apply_(S, n_max + 1)
        with pytest.raises(ValueError, match="shared memory"):
            apply_(S + 1, n_max)
    assert pcr_lines.LAUNCHES == before


def test_line_apply_calls_the_wrapper_with_the_stacked_factors():
    """line_apply_2d / line_apply3 hand the stacked factors to the wrapper (K3
    on a CUDA tensor); with PCR_KERNEL off they call the plain version."""
    factors = tlines.line_factor_2d(torch.as_tensor(_stencil(2)).float(), "r")
    f3 = tlines3.line_factor3(torch.as_tensor(_stencil(3)).float(), "z")
    b = torch.zeros((2, 3, *GRID_2D))
    seen = []

    def wrapper(F, rhs, axis):
        seen.append((F, axis))
        return rhs

    with mock.patch.object(pcr_lines, "pcr_apply_lines", wrapper):
        tlines.line_apply_2d(factors, b)
        tlines3.line_apply3(f3, torch.zeros((2, 3, *GRID_3D)))
        assert [(F is f[1], axis) for (F, axis), f in zip(seen, (factors, f3))] == [
            (True, -1), (True, -3)]
        seen.clear()
        with mock.patch.object(tlines, "PCR_KERNEL", False):
            out = tlines.line_apply_2d(factors, b)
    assert not seen and torch.equal(out, torch.zeros_like(b))


@pytest.mark.parametrize("first", ["remo3d_tpu_torch.kernels.pcr_lines",
                                   "remo3d_tpu_torch.ops.lines3d"])
def test_imports_in_either_order(first):
    """The wrapper and ops.lines import each other as modules: either may be
    imported first."""
    code = (f"import {first}; from remo3d_tpu_torch.ops import lines; "
            "from remo3d_tpu_torch.kernels import pcr_lines; "
            "assert lines.pcr_lines is pcr_lines and pcr_lines._lines is lines")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
