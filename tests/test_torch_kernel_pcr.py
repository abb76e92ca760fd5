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

import math
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("solve_axis", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("direction", ["z", "p", "r"])
def test_plain_step_bit_equal_to_its_ops(direction, dtype, solve_axis, in_place):
    """The step epilogue's plain version, base + scale * x (and scale * x
    without base), is bit for bit the two torch ops on the plain line apply,
    into a new tensor or in place over base (``out`` is base); the wrapper
    takes it on the CPU, and b is left as it was."""
    C = torch.as_tensor(_stencil(3)).to(dtype)
    axis, F = tlines3.line_factor3(C, direction)
    rng = np.random.default_rng(11)
    shape = (2, 3, *GRID_3D) if solve_axis else (2, *GRID_3D)
    b, z = (torch.as_tensor(rng.standard_normal(shape)).to(dtype) for _ in range(2))
    b_before, z_before, w = b.clone(), z.clone(), 0.6
    x = pcr_lines.pcr_apply_lines_plain(F, b, axis)
    out = z if in_place else None
    got = pcr_lines.pcr_apply_lines_plain(F, b, axis, scale=w, base=z, out=out)
    assert torch.equal(got, z_before + w * x) and torch.equal(b, b_before)
    assert (got is z) == in_place and torch.equal(z, got if in_place else z_before)
    assert torch.equal(pcr_lines.pcr_apply_lines_plain(F, b, axis, scale=w), w * x)
    assert torch.equal(pcr_lines.pcr_apply_lines(F, b, axis, scale=w, base=z_before),
                       z_before + w * x)
    with pytest.raises(ValueError, match="base needs a scale"):
        pcr_lines.pcr_apply_lines_plain(F, b, axis, base=z_before)
    with pytest.raises(ValueError, match="is not like b"):
        pcr_lines.pcr_apply_lines_plain(F, b, axis, scale=w, base=z_before[:1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim,direction", CASES)
def test_pcr_apply_rounds_each_product_and_sum(dim, direction, dtype):
    """pcr_apply is bit for bit the levels written in numpy, where every
    product and every sum is rounded on its own (no fused multiply-add), in
    K3's order: x + alpha x[i - s], then + beta x[i + s], then x dinv."""
    C = torch.as_tensor(_stencil(dim)).to(torch.float32 if dtype == np.float32 else torch.float64)
    axis, F = _factor(dim, direction, C)
    steps, dinv = tlines.split_factors(F, -3 if dim == 2 else -4)
    grid = GRID_2D if dim == 2 else GRID_3D
    b = np.random.default_rng(12).standard_normal((2, *grid)).astype(dtype)
    x = np.moveaxis(b, axis, -1)
    s = 1
    for alpha, beta in steps:
        al, be = (np.moveaxis(t.numpy(), axis, -1) for t in (alpha, beta))
        n = x.shape[-1]
        if s < n:
            nxt = x.copy()
            nxt[..., s:] = nxt[..., s:] + al[..., s:] * x[..., :-s]
            nxt[..., :-s] = nxt[..., :-s] + be[..., :-s] * x[..., s:]
            x = nxt
        s *= 2
    ref = np.moveaxis(x * np.moveaxis(dinv.numpy(), axis, -1), -1, axis)
    out = tlines.pcr_apply(steps, dinv, torch.as_tensor(b), axis=axis).numpy()
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, ref)


def test_line_view():
    assert pcr_lines.line_view((761, 161), -1) == (761, 161, 1)
    assert pcr_lines.line_view((761, 161), -2) == (1, 761, 161)
    assert pcr_lines.line_view((193, 17, 49), -3) == (1, 193, 17 * 49)
    assert pcr_lines.line_view((193, 17, 49), -2) == (193, 17, 49)
    assert pcr_lines.line_view((193, 17, 49), -1) == (193 * 17, 49, 1)


def test_wrapper_on_cpu_uses_plain_and_counts_nothing():
    """On CPU tensors: the plain version, bit-equal to line_apply's, no build
    and no count; the module counts its launches, and those with the step
    epilogue, through kernels.COUNTED."""
    assert pcr_lines in kernels.COUNTED and pcr_lines.FUSED in kernels.COUNTED
    before = (pcr_lines.LAUNCHES, pcr_lines.CAPTURED, pcr_lines.FUSED.LAUNCHES,
              pcr_lines.FUSED.CAPTURED)
    C = torch.as_tensor(_stencil(3)).float()
    factors = tlines3.line_factor3(C, "p")
    b = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 3, *GRID_3D))).float()
    with mock.patch.object(build, "load_library", side_effect=AssertionError("no build on CPU")):
        out = pcr_lines.pcr_apply_lines(factors[1], b, factors[0])
        ref = tlines3.line_apply3(factors, b)
        step = pcr_lines.pcr_apply_lines(factors[1], b, factors[0], scale=0.6, base=b)
    assert torch.equal(out, ref) and torch.equal(step, b + 0.6 * ref)
    assert (pcr_lines.LAUNCHES, pcr_lines.CAPTURED, pcr_lines.FUSED.LAUNCHES,
            pcr_lines.FUSED.CAPTURED) == before


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


def _smem(S, nodes, planes, itemsize):
    """A block's shared memory as csrc/pcr_lines.cu lays it out: x of the S
    solves twice, ``nodes`` each rounded up to 16 bytes, and ``planes``
    coefficient slots of ``nodes`` plus 16 bytes of room, rounded up."""
    V = 16 // itemsize
    return itemsize * (2 * S * (-(-nodes // V) * V) + planes * (-(-(nodes + V - 1) // V) * V))


def longest_line(S, TI, itemsize):
    """The longest line of one level (3 coefficient planes) whose S solves
    fit a block when split over a cluster of 8, TI lines per tile: the new
    limit (before the redesign a line had to fit one block, twice)."""
    seg = 1
    while _smem(S, (seg + 1) * TI, 3, itemsize) <= pcr_lines.MAX_SMEM_BYTES:
        seg += 1
    return 8 * seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lines", ["strided", "contiguous"])
def test_wrapper_refuses_a_line_beyond_shared_memory(dtype, lines):
    """No plan may need more than a block's shared memory; a line is split
    over a cluster of up to 8 blocks, so the longest line is 8 segments
    long: the longest that fits passes every check (and then needs a CUDA
    tensor), one node more, or one solve more, is refused. Strided lines
    (n, 2) along -2; contiguous lines (2, n) along -1."""
    S, size = 5, torch.empty((), dtype=dtype).element_size()
    TI = 2 if lines == "strided" else 1
    n_max = longest_line(S, TI, size)
    assert n_max > pcr_lines.MAX_SMEM_BYTES // (2 * size * S)  # longer than one block holds

    def apply_(S, n):
        grid, axis = ((n, 2), -2) if lines == "strided" else ((2, n), -1)
        F = torch.empty((1, 3, *grid), dtype=dtype, device="meta")
        return pcr_lines.pcr_apply_lines(F, torch.empty((1, S, *grid), dtype=dtype,
                                                        device="meta"), axis)

    before = pcr_lines.LAUNCHES
    with mock.patch.object(build, "load_library", return_value=object()):
        with pytest.raises(ValueError, match="CUDA tensors"):
            apply_(S, n_max)
        with pytest.raises(ValueError, match="shared memory"):
            apply_(S, n_max + 1)
        with pytest.raises(ValueError, match="shared memory"):
            apply_(S + 1, n_max)
    assert pcr_lines.LAUNCHES == before
    outer, n, inner = (1, n_max, 2) if lines == "strided" else (2, n_max, 1)
    plan = pcr_lines.tile_plan(1, S, outer, n, inner, 1, size)
    assert plan.cluster == 8 and plan.smem <= pcr_lines.MAX_SMEM_BYTES
    assert pcr_lines.tile_plan(1, S, outer, n + 1, inner, 1, size) is None


K3_SHAPES = chip_smoke.k3_shapes()


def _levels(n):
    return max(1, math.ceil(math.log2(max(n, 2))))


def _coverage(plan, outer, n, inner):
    """How many blocks hold each node of the grid (outer, n, inner) under
    ``plan``: even splits of outer and inner into tiles, each line of a tile
    split over the ``cluster`` blocks, block c holding nodes c, c + cluster,
    ... (at most ``seg`` of them; none where c >= n)."""
    count = np.zeros((outer, n, inner), dtype=np.int32)
    for to in range(plan.tiles_o):
        o0, o1 = to * outer // plan.tiles_o, (to + 1) * outer // plan.tiles_o
        assert 1 <= o1 - o0 <= plan.TO
        for ti in range(plan.tiles_i):
            j0, j1 = ti * inner // plan.tiles_i, (ti + 1) * inner // plan.tiles_i
            assert 1 <= j1 - j0 <= plan.TI
            for rank in range(plan.cluster):
                assert len(range(rank, n, plan.cluster)) <= plan.seg
                count[o0:o1, rank::plan.cluster, j0:j1] += 1
    return count


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("label,B,S,grid,axis", K3_SHAPES, ids=[s[0] for s in K3_SHAPES])
def test_tile_plan_at_the_main_path_shapes(label, B, S, grid, axis, dtype):
    """The plan of every K3 launch of the 2D and 3D logs (chip_smoke.py's
    phase 30 shapes): shared memory as the kernel lays it out and at most a
    block's; a cluster of at most 8; strided lines read in rows of at least
    32 bytes, split over a cluster (z lines of the finest 2D level and of the
    3D grid), coefficients staged in at least two stages; every node of
    every line held by exactly one block; the main five launches (float32)
    whole waves on an H100, or many."""
    size = torch.empty((), dtype=dtype).element_size()
    outer, n, inner = pcr_lines.line_view(grid, axis)
    L = _levels(n)
    S = S or 1
    plan = pcr_lines.tile_plan(B, S, outer, n, inner, L, size)
    Lr = pcr_lines.levels_run(n, L)
    assert Lr == L  # a full factor: every level changes the line
    planes = 2 * Lr + 1 if plan.stages > Lr else 2 * plan.stages
    assert plan.stages >= 2 and plan.smem == _smem(S, plan.TO * plan.seg * plan.TI, planes, size)
    assert plan.smem <= pcr_lines.MAX_SMEM_BYTES
    assert 1 <= plan.cluster <= pcr_lines.MAX_CLUSTER and plan.seg * plan.cluster >= n
    assert plan.cluster == 1 or plan.TO == 1
    if inner >= 8:  # strided lines: rows of 32 bytes or more (every tile's)
        assert (inner // plan.tiles_i) * size >= 32
    if axis == -len(grid) and (label.startswith("3D") or "level 0" in label):
        assert plan.cluster >= 2  # the z lines that a block cannot hold 8 of
    assert (_coverage(plan, outer, n, inner) == 1).all()
    assert plan in pcr_lines.candidate_plans(S, outer, n, inner, L, size)
    if label in chip_smoke.MAIN_K3_SHAPES and size == 4:  # whole waves, or many
        blocks = B * plan.tiles_o * plan.tiles_i * plan.cluster
        waves = blocks / (pcr_lines.SM_COUNT * pcr_lines.occupancy(plan.smem))
        assert waves >= 8 or waves / math.ceil(waves) >= 0.9


# Plans that chip_smoke.py --tune measured slower than tile_plan's, on an
# NVIDIA H100 80GB HBM3 at 700 W (median of 5, ms): (shape, dtype, the
# slower plan, its time, tile_plan's time). The one-vector launches of the
# coarse 2D levels with PR 13's floor of 1024 blocks or more (its kernel held
# 2 z lines a block; this one holds many), and the float64 plans of one block
# per SM that the model chose while it counted nodes, not bytes.
MEASURED_SLOWER = [
    ("2D level 2 z, power iteration", 4, (1, 11, 1, 4, 4, 48, 2, 12736), 0.0654, 0.0376),
    ("2D level 2 z, power iteration", 8, (1, 6, 1, 8, 2, 96, 2, 27712), 0.0585, 0.0515),
    ("2D level 2 r, power iteration", 4, (12, 1, 16, 1, 1, 41, 2, 11872), 0.0345, 0.0220),
    ("2D level 2 r, power iteration", 8, (12, 1, 16, 1, 1, 41, 2, 23680), 0.0383, 0.0330),
    ("2D level 3 z, power iteration", 4, (1, 11, 1, 2, 8, 12, 2, 3232), 0.0515, 0.0167),
    ("2D level 3 z, power iteration", 8, (1, 6, 1, 4, 4, 24, 2, 6976), 0.0474, 0.0213),
    ("2D level 3 r, power iteration", 4, (7, 1, 14, 1, 1, 21, 2, 3616), 0.0253, 0.0144),
    ("2D level 3 r, power iteration", 8, (7, 1, 14, 1, 1, 21, 2, 7104), 0.0259, 0.0152),
    ("2D level 0 z", 8, (1, 5, 1, 33, 2, 381, 2, 213472), 2.1952, 1.9253),
    ("2D level 0 r", 8, (12, 1, 64, 1, 1, 161, 2, 216448), 0.9660, 0.8103),
    ("2D level 1 r", 8, (24, 1, 16, 1, 1, 81, 2, 217792), 0.2353, 0.2008),
    ("2D level 2 r", 8, (39, 1, 5, 1, 1, 41, 2, 179200), 0.0696, 0.0534),
    ("3D z", 8, (1, 21, 1, 40, 2, 97, 2, 228256), 0.2170, 0.2066),
    ("3D p", 8, (2, 49, 97, 1, 1, 17, 2, 186656), 0.1153, 0.1016),
]


@pytest.mark.parametrize("label,size,slower,slower_ms,plan_ms", MEASURED_SLOWER,
                         ids=[f"{m[0]}-{m[1] * 8}" for m in MEASURED_SLOWER])
def test_estimated_cost_ranks_measured_plans(label, size, slower, slower_ms, plan_ms):
    """The cost model puts each plan that was measured slower than
    tile_plan's above it: no floor of 1024 blocks for one-vector launches
    (their plans keep fewer), and no float64 tile of one block per SM."""
    _, B, S, grid, axis = next(s for s in K3_SHAPES if s[0] == label)
    outer, n, inner = pcr_lines.line_view(grid, axis)
    S, L = S or 1, _levels(n)
    slower = pcr_lines.Plan(*slower)
    plan = pcr_lines.tile_plan(B, S, outer, n, inner, L, size)
    assert slower in pcr_lines.candidate_plans(S, outer, n, inner, L, size)
    assert slower_ms > plan_ms
    assert pcr_lines.estimated_cost(B, S, size, slower) > pcr_lines.estimated_cost(B, S, size, plan)
    if S == 1:
        assert B * slower.tiles_o * slower.tiles_i * slower.cluster >= 1024
        assert B * plan.tiles_o * plan.tiles_i * plan.cluster < 1024
    else:
        assert pcr_lines.occupancy(slower.smem) == 1 < pcr_lines.occupancy(plan.smem)


def test_tile_plan_at_the_3d_log_shapes():
    """The 3D chunk (8 batches, 5 solves, 193x17x49), float32: z lines split
    over clusters of 2 in tiles of 17 lines (68-byte rows), p lines two
    p-planes (98 lines) a tile, r lines 34 a tile; each a ring of two
    coefficient stages, two blocks of about 92 KB per SM, 3 waves on 132
    SMs. Where every level's coefficients fit beside x at no cost (2D level
    2 r lines), they are staged at once with b."""
    z = pcr_lines.tile_plan(8, 5, 1, 193, 17 * 49, 8, 4)
    assert (z.TI, z.tiles_i, z.cluster, z.seg, z.stages) == (17, 49, 2, 97, 2)
    p = pcr_lines.tile_plan(8, 5, 193, 17, 49, 5, 4)
    assert (p.TO, p.TI, p.cluster, p.stages) == (2, 49, 1, 2)
    r = pcr_lines.tile_plan(8, 5, 193 * 17, 49, 1, 6, 4)
    assert (r.TO, r.cluster, r.stages) == (34, 1, 2)
    for plan in (z, p, r):
        assert pcr_lines.occupancy(plan.smem) == 2
    assert {8 * q.tiles_o * q.tiles_i * q.cluster for q in (z, p, r)} == {784, 776}
    r2 = pcr_lines.tile_plan(74, 5, 191, 41, 1, 6, 4)
    assert r2.stages == 7 and r2.smem == _smem(5, r2.TO * 41, 13, 4)


def test_pcr_kernel_bytes_at_the_main_shapes():
    """K3's least bytes at the main paths' finest shapes (PERF.md's kernel
    table), n (2k + 1) - 2 (2^k - 1) coefficients a line: 2D z lines
    (74,5,761x161) 10 levels 1026.7 MB, r lines 8 levels 864.3 MB; 3D
    (8,5,193x17x49) z 8 levels 125.3 MB, p 5 levels 89.3 MB, r 6 levels 105.1
    MB. chip_smoke.py's bounds use least_work."""
    for B, grid, k, axis, mb in (
            (74, (761, 161), 10, -2, 1026.7), (74, (761, 161), 8, -1, 864.3),
            (8, (193, 17, 49), 8, -3, 125.3), (8, (193, 17, 49), 5, -2, 89.3),
            (8, (193, 17, 49), 6, -1, 105.1)):
        n = grid[axis]
        assert pcr_lines.coefficient_values(n, k) == n * (2 * k + 1) - 2 * (2**k - 1)
        got = pcr_lines.least_work(B, 5, grid, axis, k, 4)[0]
        lines = B * math.prod(grid) // n
        assert got == 4 * lines * (2 * 5 * n + pcr_lines.coefficient_values(n, k))
        assert got / 1e6 == pytest.approx(mb, abs=0.05)


def test_estimated_cost_prefers_whole_waves():
    """The cost model counts whole waves: 784 blocks of two per SM (2.97
    waves) cost 3 waves, 800 cost 4."""
    a = pcr_lines.make_plan(5, 1, 193, 833, 8, 4, 1, 49, 2, 2)
    b = pcr_lines.make_plan(5, 1, 193, 833, 8, 4, 1, 50, 2, 2)
    assert pcr_lines.occupancy(a.smem) == pcr_lines.occupancy(b.smem) == 2
    assert pcr_lines.estimated_cost(8, 5, 4, a) < pcr_lines.estimated_cost(8, 5, 4, b)


def test_make_plan_and_refusal_follow_the_plan():
    """make_plan's even splits and segments; a line too long for any plan is
    refused by _check before anything is built."""
    p = pcr_lines.make_plan(5, 1, 761, 161, 10, 4, 1, 13, 8, 2)
    assert (p.TO, p.TI, p.seg) == (1, 13, 96) and p.smem == _smem(5, 13 * 96, 4, 4)
    assert pcr_lines.make_plan(1, 2, 2, 3, 1, 8, 1, 1, 4, 2).seg == 1  # n shorter than the cluster
    F = torch.empty((1, 3, 40000, 1), device="meta")
    with mock.patch.object(build, "load_library", side_effect=AssertionError("built")):
        with pytest.raises(ValueError, match="shared memory"):
            pcr_lines.pcr_apply_lines(F, torch.empty((1, 5, 40000, 1), device="meta"), -2)


def test_line_apply_calls_the_wrapper_with_the_stacked_factors():
    """line_apply_2d / line_apply3 hand the stacked factors to the wrapper (K3
    on a CUDA tensor), line_apply3 its step arguments too; with PCR_KERNEL
    off they call the plain version."""
    factors = tlines.line_factor_2d(torch.as_tensor(_stencil(2)).float(), "r")
    f3 = tlines3.line_factor3(torch.as_tensor(_stencil(3)).float(), "z")
    b = torch.zeros((2, 3, *GRID_2D))
    b3 = torch.zeros((2, 3, *GRID_3D))
    seen, steps = [], []

    def wrapper(F, rhs, axis, **step):
        seen.append((F, axis))
        steps.append(step)
        return rhs

    with mock.patch.object(pcr_lines, "pcr_apply_lines", wrapper):
        tlines.line_apply_2d(factors, b)
        tlines3.line_apply3(f3, b3)
        assert [(F is f[1], axis) for (F, axis), f in zip(seen, (factors, f3))] == [
            (True, -1), (True, -3)]
        tlines3.line_apply3(f3, b3, scale=0.5, base=b3, out=b3)
        assert steps[0] == {} and steps[1] == {"scale": None, "base": None, "out": None}
        assert steps[2]["scale"] == 0.5 and steps[2]["base"] is b3 and steps[2]["out"] is b3
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


def test_wrapper_refuses_a_plane_beyond_int_offsets():
    """Offsets inside a plane are 32-bit in the kernel: a grid of 2^31 nodes
    or more is refused before anything is built."""
    F = torch.empty((1, 3, 2**16, 2**15), device="meta")
    b = torch.empty((1, 1, 2**16, 2**15), device="meta")
    with mock.patch.object(build, "load_library", side_effect=AssertionError("built")):
        with pytest.raises(ValueError, match="int sizes"):
            pcr_lines.pcr_apply_lines(F, b, -2)
