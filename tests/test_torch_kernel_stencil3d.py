# -*- coding: utf-8 -*-
"""Kernel K2 (symmetric half-storage 27-point stencil apply).

On the CPU: the plain torch version against the JAX Pallas kernel (interpreter
mode, as tests/test_pallas.py runs it, with the automatic z-slabs and a forced
2-row slab so the z-tiled path is the reference too) and against the full
27-plane apply of both packages, at rtol 2e-5 / atol 1e-5 (the Pallas test's
tolerance: summation orders differ), with the pole tie off and on (on: the
JAX package's ``pole_project`` around its Pallas apply); the half storage is
exact; the 3D solve routes every operator apply through the wrapper, the CG
matvec and the sweep with the pole tie fused, the boundary lift without; and
the wrapper never falls back from the kernel. The kernel itself runs on the card only:
tests/test_torch_cuda.py.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_symmetric_stencil_3d
from remo3d_tpu.ops import pallas_stencil as jpallas
from remo3d_tpu.ops.stencil3d import pole_project as jpole_project
from remo3d_tpu.ops.stencil3d import stencil3d_apply as jstencil3d_apply
from remo3d_tpu_torch.kernels import build, stencil3d
from remo3d_tpu_torch.ops.stencil3d import pole_project as tpole_project
from remo3d_tpu_torch.ops.stencil3d import stencil3d_apply as tstencil3d_apply
from remo3d_tpu_torch.parallel import runtime

torch.set_num_threads(2)
CPU = jax.devices("cpu")[0]
SHAPES = [(1, 2, 6, 3, 5), (2, 3, 9, 5, 7)]


def _inputs(shape, seed=7):
    """A random symmetric stencil (chip_smoke's construction, after
    tests/test_pallas.py) and a random u, float32."""
    rng = np.random.default_rng(seed)
    B, S, NZ, NP, NR = shape
    C = random_symmetric_stencil_3d(rng, B, NZ, NP, NR).astype(np.float32)
    return C, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_pallas_and_full_apply(shape):
    from jax.experimental import pallas as pl

    C, u = _inputs(shape)
    B, S, NZ, NP, NR = shape
    with jax.default_device(CPU):
        C_j, u_j = jnp.asarray(C), jnp.asarray(u)
        ref_xla = jstencil3d_apply(C_j, u_j)
        C_half_j = jpallas.half_planes(C_j)
        orig = pl.pallas_call
        with mock.patch.object(
            pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True})
        ):
            refs = [
                jpallas.stencil3d_apply_pallas(
                    jpallas.stage_half_plane_slabs(C_half_j, np_=NP, nr=NR, nz_chunk=nzc),
                    u_j, n_solves=S,
                )
                for nzc in (None, 2)  # automatic (one slab) and z-tiled slabs
            ]
    C_t, u_t = torch.as_tensor(C), torch.as_tensor(u)
    out = stencil3d.stencil3d_apply_half_plain(stencil3d.half_planes_3d(C_t), u_t)
    for ref in (*refs, ref_xla):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-5)
    # The port's full-storage apply is the same operator.
    np.testing.assert_allclose(
        tstencil3d_apply(C_t, u_t).numpy(), np.asarray(ref_xla), rtol=2e-5, atol=1e-5
    )


def _jax_pallas_apply(C, u, shape, pole):
    """The JAX package's Pallas apply in interpreter mode, between two
    ``pole_project`` calls if ``pole``."""
    from jax.experimental import pallas as pl

    _, S, _, NP, NR = shape
    with jax.default_device(CPU):
        C_half_j = jpallas.half_planes(jnp.asarray(C))
        u_j = jnp.asarray(u)
        orig = pl.pallas_call
        with mock.patch.object(
            pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True})
        ):
            staged = jpallas.stage_half_plane_slabs(C_half_j, np_=NP, nr=NR)
            y = jpallas.stencil3d_apply_pallas(
                staged, jpole_project(u_j) if pole else u_j, n_solves=S)
        return np.asarray(jpole_project(y) if pole else y)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_with_pole_tie_matches_jax_pallas_between_projections(shape):
    """``pole=True`` is P A P of the JAX package (its Pallas kernel between two
    ``pole_project`` calls), at the Pallas test's tolerance; it equals the
    port's own composition exactly, and leaves u untouched."""
    C, u = _inputs(shape)
    C_half = stencil3d.half_planes_3d(torch.as_tensor(C))
    u_t = torch.as_tensor(u.copy())
    out = stencil3d.stencil3d_apply_half_plain(C_half, u_t, pole=True)
    np.testing.assert_array_equal(u_t.numpy(), u)
    np.testing.assert_allclose(
        out.numpy(), _jax_pallas_apply(C, u, shape, pole=True), rtol=2e-5, atol=1e-5)
    composed = tpole_project(stencil3d.stencil3d_apply_half_plain(C_half, tpole_project(u_t)))
    np.testing.assert_array_equal(out.numpy(), composed.numpy())
    # The tie is a projector: tied rows are constant over the azimuth.
    assert float((out[..., :, 0] - out[..., :1, 0]).abs().max()) == 0.0


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_without_pole_tie_is_unchanged(shape):
    """``pole=False`` (the default) is y = A u as before: equal to the call
    without the argument and to the JAX Pallas apply."""
    C, u = _inputs(shape)
    C_half = stencil3d.half_planes_3d(torch.as_tensor(C))
    out = stencil3d.stencil3d_apply_half_plain(C_half, torch.as_tensor(u), pole=False)
    np.testing.assert_array_equal(
        out.numpy(), stencil3d.stencil3d_apply_half_plain(C_half, torch.as_tensor(u)).numpy())
    np.testing.assert_allclose(
        out.numpy(), _jax_pallas_apply(C, u, shape, pole=False), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_half_planes_bit_equal(shape):
    C, _ = _inputs(shape)
    with jax.default_device(CPU):
        ref = np.asarray(jpallas.half_planes(jnp.asarray(C)))
    out = stencil3d.half_planes_3d(torch.as_tensor(C))
    assert out.is_contiguous() and out.shape == shape[:1] + (14,) + shape[2:]
    np.testing.assert_array_equal(out.numpy().reshape(ref.shape), ref)
    assert stencil3d.POS_OFFSETS == jpallas.POS_OFFSETS
    assert stencil3d.HALF_ENTRIES == jpallas.HALF_ENTRIES


@pytest.mark.parametrize("pole", [False, True])
def test_wrapper_on_cpu_uses_plain_and_counts_nothing(pole):
    C, u = _inputs(SHAPES[1])
    C_half = stencil3d.half_planes_3d(torch.as_tensor(C))
    before = stencil3d.LAUNCHES
    with mock.patch.object(build, "load_library", side_effect=AssertionError("no build on CPU")):
        out = stencil3d.stencil3d_apply_half(C_half, torch.as_tensor(u), pole=pole)
    assert stencil3d.LAUNCHES == before
    np.testing.assert_array_equal(
        out.numpy(),
        stencil3d.stencil3d_apply_half_plain(C_half, torch.as_tensor(u), pole=pole).numpy(),
    )


def test_wrapper_raises_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel or raises: a failed
    build propagates, and a device, shape, dtype, layout or size the kernel
    cannot serve is refused, with no plain fallback and no count."""
    B, S, NZ, NP, NR = SHAPES[1]
    C_half = torch.empty((B, 14, NZ, NP, NR), device="meta")
    u = torch.empty((B, S, NZ, NP, NR), device="meta")
    before = stencil3d.LAUNCHES
    with mock.patch.object(
        stencil3d, "stencil3d_apply_half_plain", side_effect=AssertionError("fell back")
    ):
        with mock.patch.object(
            build, "load_library", side_effect=build.BuildError("nvcc failed (mocked)")
        ):
            with pytest.raises(build.BuildError, match="mocked"):
                stencil3d.stencil3d_apply_half(C_half, u)
        with mock.patch.object(build, "load_library", return_value=object()):
            with pytest.raises(ValueError, match="CUDA"):
                stencil3d.stencil3d_apply_half(C_half, u)
            with pytest.raises(ValueError, match="CUDA"):
                stencil3d.stencil3d_apply_half(C_half, u, pole=True)
            with pytest.raises(ValueError, match="contiguous"):
                strided = torch.empty((B, S, NZ, NR, NP), device="meta").transpose(3, 4)
                stencil3d.stencil3d_apply_half(C_half, strided)
            with pytest.raises(ValueError, match="float32 or float64"):
                stencil3d.stencil3d_apply_half(C_half.half(), u.half())
            with pytest.raises(ValueError, match="does not match"):
                stencil3d.stencil3d_apply_half(C_half[:, :13], u)
            with pytest.raises(ValueError, match="expected"):
                stencil3d.stencil3d_apply_half(C_half[0], u[0])
            big = torch.empty((8, 5, 1000, 300, 200), device="meta")
            with pytest.raises(ValueError, match="int32"):
                stencil3d.stencil3d_apply_half(torch.empty((8, 14) + big.shape[2:], device="meta"), big)
    assert stencil3d.LAUNCHES == before


def test_3d_solve_routes_every_apply_through_the_wrapper():
    """With ``use_kernel`` the 3D chunk solve applies the operator only through
    the half-storage wrapper: the boundary lift once (no pole tie), the initial
    ADI sweep 4 times, then 5 times per CG iteration (matvec + sweep), all of
    these with the pole tie fused (``pole=True``) and no ``pole_project`` call
    of the solver's own around them: one remains per preconditioner
    application (its residual), beside five in-place ties of the axis column
    (``pole_tie_``, after its five line solves), and one for the load. With
    it off, only the full 27-plane apply runs, between two ``pole_project``
    calls, and the two agree."""
    from tests.test_torch_ops3d import make_problem

    p = make_problem()
    args = [torch.as_tensor(p[k]) for k in ("coords", "sigma", "free", "src_i", "src_fac")]
    kw = dict(tol=1e-5, maxiter=400, metric="cylindrical")
    calls = {"half": 0, "half_pole": 0, "full": 0, "project": 0, "tie": 0}
    half, full, project, tie = (runtime.stencil3d_apply_half, runtime.stencil3d_apply,
                                runtime.pole_project, runtime.pole_tie_)

    def count(name, fn):
        def wrapped(*a, pole=None):
            calls[name] += 1
            if pole is None:
                return fn(*a)
            calls["half_pole"] += bool(pole)
            return fn(*a, pole=pole)
        return wrapped

    with mock.patch.object(runtime, "stencil3d_apply_half", count("half", half)), \
            mock.patch.object(runtime, "stencil3d_apply", count("full", full)), \
            mock.patch.object(runtime, "pole_project", count("project", project)), \
            mock.patch.object(runtime, "pole_tie_", count("tie", tie)):
        ua_k, _, it_k = runtime._solve_chunk_3d(*args, use_kernel=True, **kw)
        n_k = 5 + 5 * it_k
        # Every apply but the boundary lift carries the tie; the solver itself
        # projects only the load and inside the preconditioner (1 per sweep,
        # and 5 ties in place).
        assert calls == {"half": n_k, "half_pole": n_k - 1, "full": 0,
                         "project": 1 + (1 + it_k), "tie": 5 * (1 + it_k)}
        ua_p, _, it_p = runtime._solve_chunk_3d(*args, use_kernel=False, **kw)
        n_p = 5 + 5 * it_p
        assert calls["half"] == n_k and calls["full"] == n_p
        assert calls["project"] == 1 + (1 + it_k) + 1 + (1 + it_p) + 2 * (n_p - 1)
        assert calls["tie"] == 5 * (1 + it_k) + 5 * (1 + it_p)
    assert abs(it_k - it_p) <= 1
    np.testing.assert_allclose(ua_k.numpy(), ua_p.numpy(), rtol=1e-4,
                               atol=1e-4 * float(ua_p.abs().max()))


def test_3d_solve_with_fused_pole_tie_matches_jax():
    """``_solve_chunk_3d`` with the fused matvec (``use_kernel=True``: on the
    CPU the plain ``pole=True`` version) against the JAX package's chunk
    solve, as tests/test_torch_ops3d.py holds the chunk solve: the iteration
    count within 2%, the axis potentials within 1e-4 of their magnitude."""
    from remo3d_tpu.parallel.runtime import _solve_chunk_3d as j_solve_chunk_3d
    from tests.test_torch_ops3d import make_problem

    p = make_problem()
    keys = ("coords", "sigma", "free", "src_i", "src_fac")
    kw = dict(tol=1e-5, maxiter=400, metric="cylindrical")
    with jax.default_device(CPU):
        args_j = [jnp.asarray(p[k].astype(np.int32) if k == "src_i" else p[k]) for k in keys]
        ua_j, _, it_j = j_solve_chunk_3d(*args_j, **kw)
    seen = []
    half = runtime.stencil3d_apply_half

    def spy(C_half, u, pole=False):
        seen.append(pole)
        return half(C_half, u, pole=pole)

    with mock.patch.object(runtime, "stencil3d_apply_half", spy):
        ua_t, rel_t, it_t = runtime._solve_chunk_3d(
            *[torch.as_tensor(p[k]) for k in keys], use_kernel=True, **kw)
    assert seen[0] is False and all(seen[1:]) and len(seen) == 5 + 5 * it_t
    assert 0 < it_t < 400 and abs(it_t - int(it_j)) <= max(1, int(it_j) // 50)
    assert float(rel_t.max()) <= 1e-5
    scale = float(np.abs(np.asarray(ua_j)).max())
    np.testing.assert_allclose(ua_t.numpy(), np.asarray(ua_j), rtol=1e-4, atol=1e-4 * scale)
