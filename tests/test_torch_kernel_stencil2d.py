# -*- coding: utf-8 -*-
"""Kernel K1 (symmetric half-storage 9-point stencil apply).

On the CPU: the plain torch version (difference form) against the JAX Pallas
kernel (diagonal form; interpreter mode, as tests/test_pallas.py runs it) and
against JAX's XLA 9-point apply, at rtol 2e-5 / atol 1e-5 (the Pallas test's
tolerance: summation orders differ); the half storage is exact; and the
wrapper never falls back from the kernel.
The kernel itself runs on the card only: tests/test_torch_cuda.py.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_symmetric_stencil_2d
from remo3d_tpu.ops import pallas_stencil2d as jpallas
from remo3d_tpu.ops.stencil import stencil_apply as jstencil_apply
from remo3d_tpu_torch.kernels import build, stencil2d
from remo3d_tpu_torch.ops.stencil import stencil_apply as tstencil_apply

torch.set_num_threads(2)
CPU = jax.devices("cpu")[0]
SHAPES = [(1, 2, 7, 5), (2, 3, 33, 17)]


def _inputs(shape, seed=11):
    """A random symmetric stencil (chip_smoke's construction, after
    tests/test_pallas.py) and a random u, float32."""
    rng = np.random.default_rng(seed)
    B, S, NZ, NR = shape
    C = random_symmetric_stencil_2d(rng, B, NZ, NR).astype(np.float32)
    return C, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_pallas_and_xla(shape):
    from jax.experimental import pallas as pl

    C, u = _inputs(shape)
    with jax.default_device(CPU):
        C_j, u_j = jnp.asarray(C), jnp.asarray(u)
        ref_xla = jstencil_apply(C_j, u_j)
        orig = pl.pallas_call
        with mock.patch.object(
            pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True})
        ):
            ref_pallas = jpallas.stencil_apply_pallas_2d(
                jpallas.half_planes_2d(C_j), u_j, n_solves=shape[1]
            )
    C_t = torch.as_tensor(C)
    out = stencil2d.stencil_apply_half_2d_plain(stencil2d.half_planes_2d(C_t), torch.as_tensor(u))
    for ref in (ref_pallas, ref_xla):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-5)
    # The port's full-storage apply is the same operator.
    np.testing.assert_allclose(
        tstencil_apply(C_t, torch.as_tensor(u)).numpy(), np.asarray(ref_xla), rtol=2e-5, atol=1e-5
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_half_planes_bit_equal(shape):
    """The four offset planes are the JAX package's bit for bit; the port holds
    the row sum where JAX holds the diagonal: the diagonal and every coupling
    that lies inside the grid, summed in float64 and rounded once."""
    C, _ = _inputs(shape)
    with jax.default_device(CPU):
        ref = np.asarray(jpallas.half_planes_2d(jnp.asarray(C)))
    out = stencil2d.half_planes_2d(torch.as_tensor(C))
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy()[:, 1:], ref[:, 1:])
    nz, nr = shape[2:]
    row_sum = ref[:, 0].astype(np.float64)
    for k, (dz, dr) in enumerate(stencil2d.POS_OFFSETS_2D):
        (zd, zs), (rd, rs) = stencil2d._window(dz, nz), stencil2d._window(dr, nr)
        row_sum[:, zd, rd] += ref[:, k + 1, zd, rd]
        row_sum[:, zs, rs] += ref[:, k + 1, zd, rd]
    np.testing.assert_array_equal(out.numpy()[:, 0], row_sum.astype(np.float32))


def test_wrapper_on_cpu_uses_plain_and_counts_nothing():
    C, u = _inputs(SHAPES[1])
    C_half = stencil2d.half_planes_2d(torch.as_tensor(C))
    before = stencil2d.LAUNCHES
    with mock.patch.object(build, "load_library", side_effect=AssertionError("no build on CPU")):
        out = stencil2d.stencil_apply_half_2d(C_half, torch.as_tensor(u))
    assert stencil2d.LAUNCHES == before
    np.testing.assert_array_equal(
        out.numpy(), stencil2d.stencil_apply_half_2d_plain(C_half, torch.as_tensor(u)).numpy()
    )


def test_wrapper_raises_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel or raises: a failed
    build propagates, and a device the kernel cannot serve is refused, with no
    plain fallback and no count."""
    B, S, NZ, NR = SHAPES[1]
    C_half = torch.empty((B, 5, NZ, NR), device="meta")
    u = torch.empty((B, S, NZ, NR), device="meta")
    before = stencil2d.LAUNCHES
    with mock.patch.object(
        build, "load_library", side_effect=build.BuildError("nvcc failed (mocked)")
    ), mock.patch.object(
        stencil2d, "stencil_apply_half_2d_plain", side_effect=AssertionError("fell back")
    ):
        with pytest.raises(build.BuildError, match="mocked"):
            stencil2d.stencil_apply_half_2d(C_half, u)
    with mock.patch.object(build, "load_library", return_value=object()):
        with pytest.raises(ValueError, match="CUDA"):
            stencil2d.stencil_apply_half_2d(C_half, u)
        with pytest.raises(ValueError, match="contiguous"):
            strided = torch.empty((B, S, NR, NZ), device="meta").transpose(2, 3)
            stencil2d.stencil_apply_half_2d(C_half, strided)
        with pytest.raises(ValueError, match="float32 or float64"):
            stencil2d.stencil_apply_half_2d(C_half.half(), u.half())
    assert stencil2d.LAUNCHES == before


def test_build_keys_library_on_sources(tmp_path):
    """An edited kernel source gives a new library name (so it is rebuilt)."""
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    with mock.patch.object(build, "_sources", return_value=[src]):
        first = build.library_path()
        src.write_text("// v2\n")
        second = build.library_path()
    assert first != second and first.parent == build.BUILD_DIR


def test_build_failure_raises_and_leaves_nothing(tmp_path, monkeypatch):
    """A failing compiler or a missing nvcc raises BuildError; no partial
    library is left behind to be loaded later."""
    real_nvcc = build._nvcc
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_library", None)
    monkeypatch.setattr(build, "_nvcc", lambda: "false")  # exits 1
    with pytest.raises(build.BuildError, match="nvcc failed"):
        build.load_library()
    assert list((tmp_path / "_build").iterdir()) == []
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(build.BuildError, match="nvcc not found"):
        real_nvcc()
