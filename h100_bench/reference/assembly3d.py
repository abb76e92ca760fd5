# -*- coding: utf-8 -*-
# Frozen copy of remo3d_tpu_torch/ops/assembly3d.py at commit 214ab07, for the benchmark's
# reference; the benchmark never imports the program's module.
"""Isoparametric trilinear hex assembly of ``sigma * grad u . grad v`` -> 27-pt stencil.

Counterpart of ``remo3d_tpu.ops.assembly3d``, vectorized over all cells and
batch axes, with unrolled scalar*tensor arithmetic and a per-cell coordinate
translation for float32-safe Jacobians. Degenerate (pole-collapsed) hexes are
handled naturally: their Gauss-point Jacobians stay positive, and the
coincident-node DOFs are tied by the pole projector at solve time.

Two geometric metrics (``metric=``):

* ``"cartesian"`` — the nodes' (x, y, z) positions span straight-edged hexes;
  azimuth circles become chordal polygons.
* ``"cylindrical"`` — the element map is trilinear in (r, phi, z) with the true
  cylindrical metric (gradient (u_r, u_phi/r, u_z), volume weight r): the
  discrete domain is exactly the solid of revolution through the nodes. The
  azimuth angle is reconstructed from the array index (the 3D grid spaces phi
  uniformly over [0, pi]); the radius from hypot(x, y).

The stencil uses the flattened 27-entry layout of :mod:`.stencil3d`. The
JAX package's ``.at[].add`` scatters become in-place adds on slices of a fresh
tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .stencil3d import _OFFSETS, DIAG, entry_index

# Local node order: (iz, jphi, kr) corner offsets.
_CORNERS3 = tuple((a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1))
_XI = np.array([2 * a - 1 for a, b, c in _CORNERS3], dtype=float)
_ETA = np.array([2 * b - 1 for a, b, c in _CORNERS3], dtype=float)
_ZETA = np.array([2 * c - 1 for a, b, c in _CORNERS3], dtype=float)
_GAUSS = (-1.0 / np.sqrt(3.0), 1.0 / np.sqrt(3.0))


def _corner_coords(x: torch.Tensor):
    """x: (..., NZ, NP, NR) one coordinate -> list of 8 per-cell corner tensors."""
    nz, np_, nr = x.shape[-3], x.shape[-2], x.shape[-1]
    return [
        x[..., a : nz - 1 + a, b : np_ - 1 + b, c : nr - 1 + c] for a, b, c in _CORNERS3
    ]


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x^2 + y^2) in the JAX package's form (max * sqrt(1 + (min/max)^2)),
    so both packages' radii agree to the bit; ``torch.hypot`` rounds otherwise,
    and the 1/r of the cylindrical metric amplifies the last-bit differences."""
    a, b = torch.maximum(x.abs(), y.abs()), torch.minimum(x.abs(), y.abs())
    safe = torch.where(a == 0, torch.ones_like(a), a)
    return torch.where(a == 0, a, a * torch.sqrt(1 + torch.square(b / safe)))


def _cylindrical_axes(coords: torch.Tensor):
    """(r, phi, z) nodal fields from Cartesian coords; phi from the array index."""
    x = coords[..., 0]
    y = coords[..., 1]
    np_ = coords.shape[-3]
    phi_line = torch.linspace(0.0, math.pi, np_, dtype=coords.dtype, device=coords.device)
    phi = phi_line[:, None].expand(x.shape)
    return _hypot(x, y), phi, coords[..., 2]


def _metric_corners(coords: torch.Tensor, metric: str):
    """Per-corner (x, y, z) lists of the element map: Cartesian positions or
    (r, phi, z) for the cylindrical metric."""
    if metric == "cylindrical":
        axes = _cylindrical_axes(coords)
    elif metric == "cartesian":
        axes = (coords[..., 0], coords[..., 1], coords[..., 2])
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return [_corner_coords(a) for a in axes]


def _dn(gx: float, gy: float, gz: float) -> np.ndarray:
    """(8, 3) shape-function derivatives d/d(xi, eta, zeta) at one Gauss point."""
    return np.stack(
        [
            0.125 * _XI * (1 + _ETA * gy) * (1 + _ZETA * gz),
            0.125 * _ETA * (1 + _XI * gx) * (1 + _ZETA * gz),
            0.125 * _ZETA * (1 + _XI * gx) * (1 + _ETA * gy),
        ],
        axis=1,
    )


def _gauss_point(dx, dy, dz, dn):
    """Jacobian determinant and physical shape-function gradients (unrolled
    3x3 inverse-transpose) at one Gauss point of every cell."""
    J = [[None] * 3 for _ in range(3)]
    for l in range(3):
        J[0][l] = sum(float(dn[a, l]) * dx[a] for a in range(8))
        J[1][l] = sum(float(dn[a, l]) * dy[a] for a in range(8))
        J[2][l] = sum(float(dn[a, l]) * dz[a] for a in range(8))
    a00, a01, a02 = J[0]
    a10, a11, a12 = J[1]
    a20, a21, a22 = J[2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    detJ = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(detJ.abs() > 1e-30, detJ, torch.full_like(detJ, 1e-30))
    # grad_phys[a][m] = sum_l dn[a, l] * inv(J)[l, m]; inv(J)[l, m] = c_ml / det.
    gxs, gys, gzs = [], [], []
    for a in range(8):
        d0, d1, d2 = float(dn[a, 0]), float(dn[a, 1]), float(dn[a, 2])
        gxs.append((d0 * c00 + d1 * c01 + d2 * c02) * inv_det)
        gys.append((d0 * c10 + d1 * c11 + d2 * c12) * inv_det)
        gzs.append((d0 * c20 + d1 * c21 + d2 * c22) * inv_det)
    return detJ, gxs, gys, gzs


def element_matrices_3d(
    coords: torch.Tensor, sigma_cells: torch.Tensor, metric: str = "cartesian"
):
    """coords: (..., NZ, NP, NR, 3) [x, y, z]; sigma_cells: (..., NZ-1, NP-1, NR-1).

    Returns K as an 8x8 nested list of (..., NZ-1, NP-1, NR-1) tensors.
    ``metric``: "cartesian" (chordal hexes) or "cylindrical" (exact solid of
    revolution; requires the azimuth axis uniform over [0, pi], as every grid
    of :mod:`..meshing.grid3d` is).
    """
    cyl = metric == "cylindrical"
    xs, ys, zs = _metric_corners(coords, metric)
    dx = [xi - xs[0] for xi in xs]
    dy = [yi - ys[0] for yi in ys]
    dz = [zi - zs[0] for zi in zs]

    K = [[None] * 8 for _ in range(8)]
    for gx in _GAUSS:
        for gy in _GAUSS:
            for gz in _GAUSS:
                detJ, gxs, gys, gzs = _gauss_point(dx, dy, dz, _dn(gx, gy, gz))
                if cyl:
                    # Physical phi-gradient = parametric/r; volume weight r. The
                    # Gauss-point radius stays >= ~0.21*h on pole-adjacent cells.
                    n = 0.125 * (1 + _XI * gx) * (1 + _ETA * gy) * (1 + _ZETA * gz)
                    r_g = sum(float(n[a]) * xs[a] for a in range(8))
                    inv_r = 1.0 / torch.clamp_min(r_g, 1e-30)
                    gys = [g * inv_r for g in gys]
                    w = sigma_cells * detJ.abs() * r_g
                else:
                    w = sigma_cells * detJ.abs()
                for a in range(8):
                    for b in range(a, 8):
                        contrib = w * (gxs[a] * gxs[b] + gys[a] * gys[b] + gzs[a] * gzs[b])
                        K[a][b] = contrib if K[a][b] is None else K[a][b] + contrib
    for a in range(8):
        for b in range(a):
            K[a][b] = K[b][a]
    return K


def fold_to_stencil_3d(K, nz: int, np_: int, nr: int) -> torch.Tensor:
    """Fold element matrices into the (..., NZ, NP, NR, 27) nodal stencil."""
    k00 = K[0][0]
    C = torch.zeros(k00.shape[:-3] + (nz, np_, nr, 27), dtype=k00.dtype, device=k00.device)
    for a, (ai, aj, ak) in enumerate(_CORNERS3):
        for b, (bi, bj, bk) in enumerate(_CORNERS3):
            e = entry_index(bi - ai, bj - aj, bk - ak)
            C[..., ai : ai + nz - 1, aj : aj + np_ - 1, ak : ak + nr - 1, e] += K[a][b]
    return C


def apply_dirichlet_3d(C: torch.Tensor, free_mask: torch.Tensor) -> torch.Tensor:
    """Eliminate Dirichlet rows/columns: zero couplings, unit diagonal."""
    nz, np_, nr = C.shape[-4], C.shape[-3], C.shape[-2]
    free = free_mask.to(C.dtype)
    free_pad = F.pad(free, (1, 1, 1, 1, 1, 1))
    neigh = torch.stack(
        [
            free_pad[..., 1 + dz : 1 + dz + nz, 1 + dp : 1 + dp + np_, 1 + dr : 1 + dr + nr]
            for dz, dp, dr in _OFFSETS
        ],
        dim=-1,
    )  # (..., NZ, NP, NR, 27)
    C = C * (free[..., None] * neigh)
    C[..., DIAG] += 1.0 - free
    return C


def assemble_stencil_3d(coords, sigma_cells, free_mask, metric="cartesian") -> torch.Tensor:
    nz, np_, nr = coords.shape[-4], coords.shape[-3], coords.shape[-2]
    K = element_matrices_3d(coords, sigma_cells, metric=metric)
    C = fold_to_stencil_3d(K, nz, np_, nr)
    return apply_dirichlet_3d(C, free_mask)


def fundamental_potential_3d(coords, sigma0, src_z, src_fac, d_min=1e-4):
    """u_s at the grid nodes: half-space point-source fields on the borehole axis.

    The half-ball (y >= 0) carries the full current (readouts are halved
    downstream), so ``u_s = fac / (2*pi*sigma0*d)``.

    coords (B, NZ, NP, NR, 3) [(x, y, z)]; sigma0 (B,) mud conductivity;
    src_z (B, S, K); src_fac (B, S, K). Returns (B, S, NZ, NP, NR).
    """
    x = coords[..., 0][:, None]
    y = coords[..., 1][:, None]
    z = coords[..., 2][:, None]
    u = 0.0
    for k in range(src_z.shape[-1]):
        zs = src_z[..., k][..., None, None, None]
        fac = src_fac[..., k][..., None, None, None]
        d = torch.sqrt(x * x + y * y + (z - zs) ** 2)
        u = u + fac / (2.0 * math.pi * torch.clamp_min(d, d_min))
    return u / sigma0[:, None, None, None, None]


def singularity_rhs_3d(
    coords, sigma_cells, sigma0, src_z, src_fac, d_min=1e-4, metric="cartesian"
):
    """Load vector of the 3D singularity-subtracted correction problem.

    With u = u_s + w, w satisfies ``a(w, v) = -∫ (sigma - sigma0) grad(u_s)·grad(v)``
    over the half-ball; the integrand vanishes inside the borehole, which
    contains every source, so 2x2x2 Gauss quadrature is accurate wherever it is
    nonzero. Returns rhs (B, S, NZ, NP, NR) before the Dirichlet lift and the
    pole projection. In the cylindrical metric ``grad u_s`` has no e_phi
    component (the sources sit on the revolution axis).
    """
    cyl = metric == "cylindrical"
    nz, np_, nr = coords.shape[-4], coords.shape[-3], coords.shape[-2]
    xs, ys, zs_c = _metric_corners(coords, metric)
    dx = [xi - xs[0] for xi in xs]
    dy = [yi - ys[0] for yi in ys]
    dz = [zi - zs_c[0] for zi in zs_c]
    sig_dev = (sigma_cells - sigma0[:, None, None, None])[:, None]  # (B, 1, cells)
    inv_sig0 = 1.0 / sigma0[:, None, None, None, None]

    acc = [None] * 8
    for gx in _GAUSS:
        for gy in _GAUSS:
            for gz in _GAUSS:
                n = 0.125 * (1 + _XI * gx) * (1 + _ETA * gy) * (1 + _ZETA * gz)  # (8,)
                detJ, gxs, gys, gzs = _gauss_point(dx, dy, dz, _dn(gx, gy, gz))

                # Gauss-point position (B, 1, cells); x_g is the radius r_g in
                # the cylindrical metric, where phi never enters.
                x_g = sum(float(n[a]) * xs[a] for a in range(8))[:, None]
                y_g = 0.0 if cyl else sum(float(n[a]) * ys[a] for a in range(8))[:, None]
                z_g = sum(float(n[a]) * zs_c[a] for a in range(8))[:, None]

                # Analytic grad u_s at the Gauss point, summed over sources.
                gus_x = 0.0
                gus_y = 0.0
                gus_z = 0.0
                for k in range(src_z.shape[-1]):
                    zsk = src_z[..., k][..., None, None, None]  # (B, S, 1, 1, 1)
                    fac = src_fac[..., k][..., None, None, None]
                    ddz = z_g - zsk
                    d2 = x_g * x_g + (0.0 if cyl else y_g * y_g) + ddz * ddz
                    d3 = torch.clamp_min(d2, d_min * d_min) ** 1.5
                    coef = -fac / (2.0 * math.pi) * inv_sig0
                    gus_x = gus_x + coef * x_g / d3
                    if not cyl:
                        gus_y = gus_y + coef * y_g / d3
                    gus_z = gus_z + coef * ddz / d3

                w_g = sig_dev * detJ.abs()[:, None]
                if cyl:
                    w_g = w_g * x_g  # volume weight r at the Gauss point
                for a in range(8):
                    term = -w_g * (
                        gus_x * gxs[a][:, None]
                        + gus_y * gys[a][:, None]
                        + gus_z * gzs[a][:, None]
                    )
                    acc[a] = term if acc[a] is None else acc[a] + term

    rhs = torch.zeros(
        tuple(src_fac.shape[:2]) + (nz, np_, nr), dtype=coords.dtype, device=coords.device
    )
    for a, (ai, aj, ak) in enumerate(_CORNERS3):
        rhs[..., ai : ai + nz - 1, aj : aj + np_ - 1, ak : ak + nr - 1] += acc[a]
    return rhs
