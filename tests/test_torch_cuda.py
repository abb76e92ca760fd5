# -*- coding: utf-8 -*-
"""Tests of the port that need a CUDA card (marker ``cuda``); here they skip.

This file imports neither jax nor the JAX package, so it also runs where jax
is not installed. On a machine with a card:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_symmetric_stencil_2d
from remo3d_tpu_torch import Model
from remo3d_tpu_torch.kernels import stencil2d
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D

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
