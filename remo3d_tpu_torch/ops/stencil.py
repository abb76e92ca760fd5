# -*- coding: utf-8 -*-
"""9-point stencil linear operator on (NZ, NR) node arrays (full storage).

Counterpart of ``remo3d_tpu.ops.stencil``: the SpMV of the structured FEM system
is nine shifted multiply-adds on dense tensors. Supports an extra solve axis S
that shares the stencil (one matrix, many right-hand sides per batch mesh).
The symmetric half-storage apply that carries the CG and fine multigrid levels
is :mod:`remo3d_tpu_torch.kernels.stencil2d`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stencil_apply(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y = A u.

    C: (..., NZ, NR, 3, 3); u: (..., [S,] NZ, NR). When u has one more leading axis
    than C (the solve axis), the stencil broadcasts across it.
    """
    nz, nr = C.shape[-4], C.shape[-3]
    extra = u.ndim - (C.ndim - 2)  # 0 or 1 (solve axis)
    if extra not in (0, 1):
        raise ValueError(f"rank mismatch: C {tuple(C.shape)}, u {tuple(u.shape)}")
    Cb = C if extra == 0 else C.unsqueeze(-5)  # (..., 1, NZ, NR, 3, 3)
    u_pad = F.pad(u, (1, 1, 1, 1))
    y = torch.zeros_like(u)
    for di in range(3):
        for dj in range(3):
            y = y + Cb[..., di, dj] * u_pad[..., di : di + nz, dj : dj + nr]
    return y


def stencil_diag(C: torch.Tensor) -> torch.Tensor:
    """Operator diagonal (Jacobi preconditioner source)."""
    return C[..., 1, 1]
