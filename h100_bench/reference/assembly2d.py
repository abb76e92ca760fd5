# -*- coding: utf-8 -*-
# Frozen copy of remo3d_tpu_torch/ops/assembly2d.py at commit 214ab07, for the benchmark's
# reference; the benchmark never imports the program's module.
"""Isoparametric Q1 assembly of the axisymmetric operator ``2·pi·r·sigma·grad u·grad v``.

Counterpart of ``remo3d_tpu.ops.assembly2d``. The element matrices of all cells are
computed at once (vectorized over the grid and any leading batch axes) and folded
into a 9-point nodal stencil ``C[..., i, j, di, dj]`` (di, dj in {0,1,2} mapping to
neighbor offsets {-1,0,+1}) with shifted slice adds on a fresh tensor.

All small contractions (Jacobians, grad-grad products) stay unrolled scalar*tensor
arithmetic, and coordinates are translated to a per-cell origin before
differencing, so float32 keeps the O(h) Jacobian entries of O(domain)-sized
coordinates.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# Local node order within a cell (iz offset, ir offset): standard CCW quad.
_CORNERS = ((0, 0), (1, 0), (1, 1), (0, 1))
_XI = np.array([-1.0, 1.0, 1.0, -1.0])
_ETA = np.array([-1.0, -1.0, 1.0, 1.0])
_GAUSS = (-1.0 / np.sqrt(3.0), 1.0 / np.sqrt(3.0))
# The eight off-diagonal stencil entries (di, dj), in the order their sum is taken.
_COUPLINGS = tuple((di, dj) for di in range(3) for dj in range(3) if (di, dj) != (1, 1))


def _cell_corner_coords(coords: torch.Tensor):
    """Split node coords (..., NZ, NR, 2) into per-corner z and r tensors of shape
    (..., NZ-1, NR-1)."""
    z = coords[..., 0]
    r = coords[..., 1]
    zc = [z[..., :-1, :-1], z[..., 1:, :-1], z[..., 1:, 1:], z[..., :-1, 1:]]
    rc = [r[..., :-1, :-1], r[..., 1:, :-1], r[..., 1:, 1:], r[..., :-1, 1:]]
    return zc, rc


def _gauss_point(dz, dr, gx, gy):
    """Shape functions, Jacobian determinant and physical shape-function
    gradients at one Gauss point of every cell."""
    n = 0.25 * (1 + _XI * gx) * (1 + _ETA * gy)  # (4,) python floats
    dn0 = 0.25 * _XI * (1 + _ETA * gy)  # d/dxi
    dn1 = 0.25 * _ETA * (1 + _XI * gx)  # d/deta
    # Jacobian entries J[k,l] = sum_a x[a,k] * dn[a,l], unrolled.
    J00 = sum(float(dn0[a]) * dz[a] for a in range(4))
    J01 = sum(float(dn1[a]) * dz[a] for a in range(4))
    J10 = sum(float(dn0[a]) * dr[a] for a in range(4))
    J11 = sum(float(dn1[a]) * dr[a] for a in range(4))
    detJ = J00 * J11 - J01 * J10
    inv_det = 1.0 / detJ
    # Physical gradients g[a] = J^{-T} dn[a], unrolled.
    gz = [(J11 * float(dn0[a]) - J10 * float(dn1[a])) * inv_det for a in range(4)]
    gr = [(J00 * float(dn1[a]) - J01 * float(dn0[a])) * inv_det for a in range(4)]
    return n, detJ, gz, gr


def element_matrices_2d(coords: torch.Tensor, sigma_cells: torch.Tensor) -> list:
    """Element stiffness matrices for all cells.

    coords: (..., NZ, NR, 2) node positions (z, r).
    sigma_cells: (..., NZ-1, NR-1).
    Returns K as a nested 4x4 list of (..., NZ-1, NR-1) tensors (kept unstacked so
    the stencil fold below is pure shifted adds).
    """
    zc, rc = _cell_corner_coords(coords)
    # Translate to a per-cell origin: Jacobians are translation invariant and the
    # differencing below then happens at O(h) magnitudes (float32-safe).
    z0, r0 = zc[0], rc[0]
    dz = [zi - z0 for zi in zc]
    dr = [ri - r0 for ri in rc]

    K = [[None] * 4 for _ in range(4)]
    two_pi = 2.0 * np.pi
    for gx in _GAUSS:
        for gy in _GAUSS:
            n, detJ, gz, gr = _gauss_point(dz, dr, gx, gy)
            r_g = sum(float(n[a]) * rc[a] for a in range(4))
            w = two_pi * r_g * sigma_cells * torch.abs(detJ)
            for a in range(4):
                for b in range(a, 4):
                    contrib = w * (gz[a] * gz[b] + gr[a] * gr[b])
                    K[a][b] = contrib if K[a][b] is None else K[a][b] + contrib
    for a in range(4):
        for b in range(a):
            K[a][b] = K[b][a]
    return K


def fold_to_stencil(K: list, nz: int, nr: int) -> torch.Tensor:
    """Fold element matrices into the 9-point nodal stencil via shifted adds.

    The couplings are folded from ``K``; the diagonal is minus the sum of the
    row's eight couplings, summed in float64 in a fixed order and rounded once.
    Every element matrix annihilates constants, so this is the assembled
    diagonal in exact arithmetic. Folded in float32, the diagonal would miss the
    zero row sum by a few ulps, and the readouts amplify that about a
    thousandfold (PERF.md, C2; tests/test_torch_spread.py).
    """
    k00 = K[0][0]
    C = torch.zeros(k00.shape[:-2] + (nz, nr, 3, 3), dtype=k00.dtype, device=k00.device)
    for a, (ai, aj) in enumerate(_CORNERS):
        for b, (bi, bj) in enumerate(_CORNERS):
            if a != b:
                di, dj = bi - ai + 1, bj - aj + 1
                C[..., ai : ai + nz - 1, aj : aj + nr - 1, di, dj] += K[a][b]
    row_sum = None
    for di, dj in _COUPLINGS:
        c = C[..., di, dj].double()
        row_sum = c if row_sum is None else row_sum + c
    C[..., 1, 1] = (-row_sum).to(C.dtype)
    return C


def apply_dirichlet(C: torch.Tensor, free_mask: torch.Tensor) -> torch.Tensor:
    """Eliminate Dirichlet rows/columns: zero couplings, unit diagonal.

    free_mask: (..., NZ, NR) bool, True on free nodes (homogeneous BCs).
    """
    nz, nr = C.shape[-4], C.shape[-3]
    free = free_mask.to(C.dtype)
    free_pad = F.pad(free, (1, 1, 1, 1))
    neigh = torch.stack(
        [
            torch.stack(
                [free_pad[..., di : di + nz, dj : dj + nr] for dj in range(3)], dim=-1
            )
            for di in range(3)
        ],
        dim=-2,
    )  # (..., NZ, NR, 3, 3)
    C = C * (free[..., None, None] * neigh)
    C[..., 1, 1] += 1.0 - free
    return C


def assemble_stencil_2d(
    coords: torch.Tensor, sigma_cells: torch.Tensor, free_mask: torch.Tensor
) -> torch.Tensor:
    """Full assembly: element matrices -> stencil -> Dirichlet elimination."""
    nz, nr = coords.shape[-3], coords.shape[-2]
    K = element_matrices_2d(coords, sigma_cells)
    C = fold_to_stencil(K, nz, nr)
    return apply_dirichlet(C, free_mask)


def fundamental_potential_2d(coords, sigma0, src_z, src_fac, d_min=1e-4):
    """u_s at the grid nodes: sum of full-space point-source fields.

    coords (B, NZ, NR, 2) [(z, r)]; sigma0 (B,) conductivity at the sources (mud);
    src_z (B, S, K) source depths; src_fac (B, S, K) strengths (0 = unused slot).
    Returns (B, S, NZ, NR).
    """
    z = coords[..., 0][:, None, :, :]  # (B, 1, NZ, NR)
    r = coords[..., 1][:, None, :, :]
    u = 0.0
    for k in range(src_z.shape[-1]):
        zs = src_z[..., k][..., None, None]
        fac = src_fac[..., k][..., None, None]
        d = torch.sqrt((z - zs) ** 2 + r**2)
        u = u + fac / (4.0 * math.pi * torch.clamp_min(d, d_min))
    return u / sigma0[:, None, None, None]


def singularity_rhs_2d(coords, sigma_cells, sigma0, src_z, src_fac, d_min=1e-4):
    """Load vector of the singularity-subtracted correction problem.

    With u = u_s + w and u_s the exact full-space field of the sources in the
    homogeneous mud conductivity sigma0, w satisfies
    ``a(w, v) = -∫ 2·pi·r (sigma - sigma0) grad(u_s)·grad(v)``; the integrand
    vanishes wherever sigma == sigma0 (the whole borehole, which contains the
    singularity), so 2x2 Gauss quadrature is accurate everywhere it is nonzero.

    Returns rhs (B, S, NZ, NR) BEFORE the Dirichlet boundary lift.
    """
    nz, nr = coords.shape[-3], coords.shape[-2]
    zc, rc = _cell_corner_coords(coords)  # per-corner (B, NZc, NRc)
    z0, r0 = zc[0], rc[0]
    dz = [zi - z0 for zi in zc]
    dr = [ri - r0 for ri in rc]
    sig_dev = (sigma_cells - sigma0[:, None, None])[:, None]  # (B, 1, NZc, NRc)
    inv_sig0 = 1.0 / sigma0[:, None, None, None]
    two_pi = 2.0 * math.pi

    acc = [None] * 4  # per-corner accumulators (B, S, NZc, NRc)
    for gx in _GAUSS:
        for gy in _GAUSS:
            n, detJ, gz, gr = _gauss_point(dz, dr, gx, gy)
            z_g = sum(float(n[a]) * zc[a] for a in range(4))[:, None]  # (B,1,NZc,NRc)
            r_g = sum(float(n[a]) * rc[a] for a in range(4))[:, None]

            # Analytic grad u_s at the Gauss point, summed over sources.
            gus_z = 0.0
            gus_r = 0.0
            for k in range(src_z.shape[-1]):
                zs = src_z[..., k][..., None, None]  # (B, S, 1, 1)
                fac = src_fac[..., k][..., None, None]
                ddz = z_g - zs
                d2 = ddz * ddz + r_g * r_g
                d3 = torch.clamp_min(d2, d_min * d_min) ** 1.5
                coef = -fac / (4.0 * math.pi) * inv_sig0
                gus_z = gus_z + coef * ddz / d3
                gus_r = gus_r + coef * r_g / d3

            w_g = two_pi * r_g * sig_dev * torch.abs(detJ)[:, None]
            for a in range(4):
                term = -w_g * (gus_z * gz[a][:, None] + gus_r * gr[a][:, None])
                acc[a] = term if acc[a] is None else acc[a] + term

    rhs = torch.zeros(
        tuple(src_fac.shape[:2]) + (nz, nr), dtype=coords.dtype, device=coords.device
    )
    for a, (ai, aj) in enumerate(_CORNERS):
        rhs[..., ai : ai + nz - 1, aj : aj + nr - 1] += acc[a]
    return rhs
