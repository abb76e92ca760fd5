# -*- coding: utf-8 -*-
"""Tests of the port that need a CUDA card (marker ``cuda``); here they skip.

This file imports neither jax nor the JAX package, so it also runs where jax
is not installed. On a machine with a card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    BM3_BOREHOLE,
    BM3_FORMATION,
    KERNEL3D_SHAPES,
    random_symmetric_stencil_2d,
    random_symmetric_stencil_3d,
)
from remo3d_tpu_torch import Model
from remo3d_tpu_torch.kernels import stencil2d, stencil3d
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D

SHAPES = [(1, 2, 7, 5), (2, 3, 33, 17), (3, 5, 97, 33)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda_device, shape, dtype, tol):
    """K1 against its plain version on the card, to summation-order rounding
    (relative to max|y|); each call is one launch."""
    rng = np.random.default_rng(5)
    B, S, NZ, NR = shape
    C = torch.as_tensor(random_symmetric_stencil_2d(rng, B, NZ, NR), device=cuda_device)
    C_half = stencil2d.half_planes_2d(C.to(dtype))
    u = torch.as_tensor(rng.standard_normal(shape), device=cuda_device).to(dtype)
    before = stencil2d.LAUNCHES
    out = stencil2d.stencil_apply_half_2d(C_half, u)
    torch.cuda.synchronize()
    assert stencil2d.LAUNCHES == before + 1
    ref = stencil2d.stencil_apply_half_2d_plain(C_half, u)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
def test_small_log_on_card_matches_cpu(cuda_device):
    """A small float64 log on the card (kernel path) equals the CPU run (plain
    path) to the CG tolerance, and went through the kernel."""
    formation = np.array([
        [-100.0, -1.0, np.nan, np.nan, 10.0],
        [-1.0, 0.5, 0.3, 4.0, 40.0],
        [0.5, 100.0, np.nan, np.nan, 3.0],
    ])
    borehole = np.array([[-100.0, 0.1, 1.0], [100.0, 0.1, 1.0]])
    kw = dict(borehole_geometry_type="radius", verbose=False, dtype="float64", tol=1e-12,
              grid_spec=GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2),
              executor_overrides={"device_meshing": True})
    tools, depths = ["A2.0M0.5N", "B5.7A0.4M"], np.array([-0.2, 0.3])
    before = stencil2d.LAUNCHES
    gpu = Model.compute_synthetic_logs(tools, depths, formation, borehole, device="cuda", **kw)
    assert stencil2d.LAUNCHES > before
    cpu = Model.compute_synthetic_logs(tools, depths, formation, borehole, device="cpu", **kw)
    for t in tools:
        np.testing.assert_allclose(gpu.logs[t][:, 1], cpu.logs[t][:, 1], rtol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", KERNEL3D_SHAPES)
def test_kernel3d_matches_plain(cuda_device, shape, dtype, tol):
    """K2 against its plain version on the card at the 3D path's chunk shape,
    the high_dip grid and an edge case (relative to max|y|); one launch each."""
    rng = np.random.default_rng(6)
    B, S, NZ, NP, NR = shape
    C = torch.as_tensor(random_symmetric_stencil_3d(rng, B, NZ, NP, NR), device=cuda_device)
    C_half = stencil3d.half_planes_3d(C.to(dtype))
    u = torch.as_tensor(rng.standard_normal(shape), device=cuda_device).to(dtype)
    before = stencil3d.LAUNCHES
    out = stencil3d.stencil3d_apply_half(C_half, u)
    torch.cuda.synchronize()
    assert stencil3d.LAUNCHES == before + 1
    ref = stencil3d.stencil3d_apply_half_plain(C_half, u)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
def test_small_3d_log_on_card_matches_cpu(cuda_device):
    """A 3-depth float64 dip-30 log on the card (kernel path) equals the CPU
    run (plain path) to the CG tolerance, and went through K2."""
    kw = dict(borehole_geometry_type="radius", dip=30, verbose=False, dtype="float64",
              tol=1e-10, grid_spec3d=GridSpec3D(nz=49, np_=9, nr=17, n_wall_cells=3,
                                                n_blend_cells=2))
    tools, depths = ["A2.0M0.5N", "B5.7A0.4M"], np.array([11.5, 12.5, 13.5])
    before = stencil3d.LAUNCHES
    gpu = Model.compute_synthetic_logs(tools, depths, BM3_FORMATION, BM3_BOREHOLE,
                                       device="cuda", **kw)
    assert stencil3d.LAUNCHES > before
    cpu = Model.compute_synthetic_logs(tools, depths, BM3_FORMATION, BM3_BOREHOLE,
                                       device="cpu", **kw)
    for t in tools:
        np.testing.assert_allclose(gpu.logs[t][:, 1], cpu.logs[t][:, 1], rtol=1e-8)
