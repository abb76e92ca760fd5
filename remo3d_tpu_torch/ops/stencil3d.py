# -*- coding: utf-8 -*-
"""27-point stencil operator on (NZ, NP, NR) node grids + the pole projector.

Counterpart of ``remo3d_tpu.ops.stencil3d`` for the sheared-cylindrical
half-ball grids: axes are (axial z-line i, azimuth j, radial station k). The
stencil is stored with a flattened entry axis ``C[..., NZ, NP, NR, 27]`` (entry
e = ((dz+1)*3+(dp+1))*3+dr+1), as in the JAX package.

The radial station k=0 is the borehole axis, where all azimuth copies of a node
coincide physically; the orthogonal projector :func:`pole_project` ties them
(average over the azimuth), turning the full-grid operator into the exact reduced
FEM system on the tied subspace.

This is the full 27-plane apply in plain torch. The symmetric half-storage
apply that carries the 3D CG is :mod:`remo3d_tpu_torch.kernels.stencil3d`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_OFFSETS = [(dz, dp, dr) for dz in (-1, 0, 1) for dp in (-1, 0, 1) for dr in (-1, 0, 1)]


def entry_index(dz: int, dp: int, dr: int) -> int:
    """Flattened stencil entry for neighbor offset (dz, dp, dr) in {-1,0,1}^3."""
    return ((dz + 1) * 3 + (dp + 1)) * 3 + (dr + 1)


DIAG = entry_index(0, 0, 0)


def stencil3d_apply(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y = A u.  C: (..., NZ, NP, NR, 27); u: (..., [S,] NZ, NP, NR)."""
    nz, np_, nr = C.shape[-4], C.shape[-3], C.shape[-2]
    extra = u.ndim - (C.ndim - 1)
    if extra not in (0, 1):
        raise ValueError(f"rank mismatch: C {tuple(C.shape)}, u {tuple(u.shape)}")
    Cb = C if extra == 0 else C.unsqueeze(-5)
    u_pad = F.pad(u, (1, 1, 1, 1, 1, 1))
    y = torch.zeros_like(u)
    for dz, dp, dr in _OFFSETS:
        e = entry_index(dz, dp, dr)
        y = y + Cb[..., e] * u_pad[
            ..., 1 + dz : 1 + dz + nz, 1 + dp : 1 + dp + np_, 1 + dr : 1 + dr + nr
        ]
    return y


def stencil3d_diag(C: torch.Tensor) -> torch.Tensor:
    return C[..., DIAG]


def pole_project(u: torch.Tensor) -> torch.Tensor:
    """Average the coincident axis DOFs over the azimuth (radial station 0).

    Returns a new tensor; ``u`` is not modified.
    """
    out = u.clone()
    out[..., :, :, 0] = u[..., :, :, 0].mean(dim=-1, keepdim=True)
    return out
