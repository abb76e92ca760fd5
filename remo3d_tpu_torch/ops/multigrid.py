# -*- coding: utf-8 -*-
"""Geometric multigrid V-cycle preconditioner on the structured stencil hierarchy.

Counterpart of ``remo3d_tpu.ops.multigrid``:

* coarse levels are every-2nd-node subgrids (nested bilinear FEM spaces);
* coarse operators are EXACT Galerkin products P^T A P, computed on the 9-point
  stencils with 9 "comb" probes, with the Dirichlet elimination re-applied on
  the strided free mask;
* restriction is the FEM adjoint P^T of bilinear prolongation;
* smoothing is CHEBYSHEV over factored-PCR line solves (or Jacobi), with
  per-batch spectral-radius estimates from power iteration.

Everything is dense shifted-tensor arithmetic, vectorized over batch and solve
axes, and a fixed linear SPD operator as PCG requires.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.stencil2d import half_planes_2d, stencil_apply_half_2d
from .assembly2d import apply_dirichlet, assemble_stencil_2d
from .lines import line_apply_2d, line_factor_2d
from .stencil import stencil_apply, stencil_diag


@dataclasses.dataclass(frozen=True)
class MGConfig:
    n_levels: int = 4
    degree_pre: int = 3  # Chebyshev degree of the pre-smoother
    degree_post: int = 3
    coarse_degree: int = 24  # Chebyshev degree on the coarsest level
    lower_frac: float = 0.25  # target interval [lower_frac*lmax, 1.05*lmax]
    power_iters: int = 12
    # Inner preconditioner of the Chebyshev smoother: "line_rz" is additive
    # alternating-direction line relaxation (radial + axial tridiagonal solves),
    # needed because the graded tensor grid carries BOTH anisotropy orientations.
    # "line_r" and "jacobi" are cheaper but stall on one orientation each.
    smoother: str = "line_rz"
    # Operator applies on the N finest levels go through the half-storage
    # stencil wrapper (the CUDA kernel for CUDA tensors).
    kernel_levels: int = 0
    # Truncate the PCR line solves to this many reduction levels (an approximate
    # solve within a 2^k window); None = exact (ceil(log2(n)) levels).
    line_max_steps: int | None = None


def coarsen_cells(cells: torch.Tensor) -> torch.Tensor:
    """2x2 arithmetic average of cell values -> coarse cells."""
    return 0.25 * (
        cells[..., 0::2, 0::2]
        + cells[..., 1::2, 0::2]
        + cells[..., 0::2, 1::2]
        + cells[..., 1::2, 1::2]
    )


def prolong(zc: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation coarse -> fine (fine size 2*(n-1)+1)."""
    sz = zc.shape
    nzf, nrf = 2 * (sz[-2] - 1) + 1, 2 * (sz[-1] - 1) + 1
    f = torch.zeros(sz[:-2] + (nzf, nrf), dtype=zc.dtype, device=zc.device)
    f[..., 0::2, 0::2] = zc
    f[..., 1::2, 0::2] = 0.5 * (zc[..., :-1, :] + zc[..., 1:, :])
    f[..., 0::2, 1::2] = 0.5 * (zc[..., :, :-1] + zc[..., :, 1:])
    f[..., 1::2, 1::2] = 0.25 * (
        zc[..., :-1, :-1] + zc[..., 1:, :-1] + zc[..., :-1, 1:] + zc[..., 1:, 1:]
    )
    return f


def restrict(r: torch.Tensor) -> torch.Tensor:
    """FEM adjoint of bilinear prolongation: rc = P^T r."""
    rp = F.pad(r, (1, 1, 1, 1))
    c = r[..., 0::2, 0::2]
    c = c + 0.5 * (
        rp[..., 0:-2:2, 1:-1:2]
        + rp[..., 2::2, 1:-1:2]
        + rp[..., 1:-1:2, 0:-2:2]
        + rp[..., 1:-1:2, 2::2]
    )
    c = c + 0.25 * (
        rp[..., 0:-2:2, 0:-2:2]
        + rp[..., 2::2, 0:-2:2]
        + rp[..., 0:-2:2, 2::2]
        + rp[..., 2::2, 2::2]
    )
    return c


def galerkin_coarsen(C: torch.Tensor, coarse_free: torch.Tensor) -> torch.Tensor:
    """Exact Galerkin coarse stencil C_H = P^T C P for bilinear P.

    C_H is again a 9-point stencil, so its columns are probed with 9 "comb"
    vectors (coarse deltas on a stride-3 lattice whose prolongated supports cannot
    overlap): y = P^T (C (P e_comb)) holds one full column of C_H per comb node,
    rearranged into stencil layout with one gather.
    """
    nz, nr = C.shape[-4], C.shape[-3]
    nzc, nrc = (nz + 1) // 2, (nr + 1) // 2
    lead = tuple(C.shape[:-4])
    combs = np.zeros((9, nzc, nrc), dtype=np.float32)
    for a in range(3):
        for b in range(3):
            combs[a * 3 + b, a::3, b::3] = 1.0
    comb = torch.as_tensor(combs, dtype=C.dtype, device=C.device).expand(lead + (9, nzc, nrc))
    y = restrict(stencil_apply(C, prolong(comb)))
    y_t = torch.movedim(y, -3, -1)  # (..., nzc, nrc, 9)

    # Stencil entry (dI,dJ) at node (i,j) couples to the neighbor (i+dI, j+dJ),
    # whose probe is the comb with residues ((i+dI)%3, (j+dJ)%3).
    iz = np.arange(nzc)[:, None]
    jr = np.arange(nrc)[None, :]
    idx = np.empty((nzc, nrc, 9), dtype=np.int64)
    for dI in (-1, 0, 1):
        for dJ in (-1, 0, 1):
            e = (dI + 1) * 3 + (dJ + 1)
            idx[..., e] = ((iz + dI) % 3) * 3 + ((jr + dJ) % 3)
    index = torch.as_tensor(idx, device=C.device).expand(y_t.shape)
    CH = torch.gather(y_t, -1, index)
    CH = CH.reshape(CH.shape[:-1] + (3, 3))
    return apply_dirichlet(CH, coarse_free)


def _make_precond(C, inv_diag, smoother: str, max_steps=None):
    """Inner smoother preconditioner apply: r -> M^{-1} r (identity on Dirichlet).

    The tridiagonal line parts are FACTORED once per level: the PCR elimination
    coefficients depend only on the operator, so every smoother application pays
    two shifted multiply-adds per reduction level.
    """
    if smoother == "jacobi":

        def apply_(r):
            inv_d = inv_diag if r.ndim == inv_diag.ndim else inv_diag.unsqueeze(-3)
            return inv_d * r

    elif smoother == "line_r":
        f_r = line_factor_2d(C, "r", max_steps=max_steps)

        def apply_(r):
            return line_apply_2d(f_r, r)

    elif smoother == "line_rz":
        f_r = line_factor_2d(C, "r", max_steps=max_steps)
        f_z = line_factor_2d(C, "z", max_steps=max_steps)

        def apply_(r):
            # Additive ADI: symmetric (PCG-safe), both orientations.
            return 0.5 * (line_apply_2d(f_r, r) + line_apply_2d(f_z, r))

    else:
        raise ValueError(f"unknown smoother {smoother!r}")
    return apply_


def make_stencil_apply(C, use_kernel: bool):
    """Operator apply for one level: the half-storage stencil wrapper (the CUDA
    kernel for CUDA tensors) when enabled and the operand carries the
    production (B, S, NZ, NR) rank, the full 9-point apply otherwise."""
    if not use_kernel:
        return lambda u, C=C: stencil_apply(C, u)
    C_half = half_planes_2d(C)

    def apply_(u, C=C, C_half=C_half):
        if u.ndim == 4 and C.ndim == 5:
            return stencil_apply_half_2d(C_half, u)
        return stencil_apply(C, u)

    return apply_


def _estimate_lmax(C, precond, power_iters: int) -> torch.Tensor:
    """Per-batch spectral radius of M^{-1} A via power iteration.

    Returns a tensor with C's leading (batch) shape. The start vector is the JAX
    package's (numpy ``default_rng(12345)``), so both compute the same thing.
    """
    nz, nr = C.shape[-4], C.shape[-3]
    rng = np.random.default_rng(12345)
    x0 = torch.as_tensor(rng.standard_normal((nz, nr)), dtype=C.dtype, device=C.device)
    x = x0.expand(C.shape[:-2])  # (..., nz, nr)
    lmax = None
    for _ in range(power_iters):
        y = precond(stencil_apply(C, x))
        lmax = torch.sqrt(torch.sum(y * y, dim=(-2, -1)) / torch.sum(x * x, dim=(-2, -1)))
        x = y / (lmax[..., None, None] + 1e-30)
    return lmax


def _chebyshev_smooth(level, r, z, degree: int, lower_frac: float):
    """``degree`` iterations of preconditioned Chebyshev on A z = r, targeting
    the interval [lower_frac*lmax, 1.05*lmax] (Saad, Iterative Methods, Alg. 12.1
    adapted to preconditioned form)."""
    if degree <= 0:
        return z
    free, lmax = level["free"], level["lmax"]
    precond = level["precond"]
    if r.ndim - (level["C"].ndim - 2) == 1:
        free = free.unsqueeze(-3)
        lmax = lmax.unsqueeze(-1)
    lmax = lmax[..., None, None] * 1.05
    lmin = lmax * lower_frac
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma

    apply_A = level["apply"]

    def precond_residual(z):
        res = r - apply_A(z)
        return precond(torch.where(free, res, torch.zeros_like(res)))

    d = precond_residual(z) / theta
    z = z + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * precond_residual(z)
        z = z + d
        rho = rho_new
    return z


def build_hierarchy(coords, sigma_cells, free_mask, config: MGConfig, C_fine=None):
    """Assemble the fine stencil, Galerkin-coarsen down, estimate spectra."""
    nz, nr = coords.shape[-3], coords.shape[-2]
    for l in range(config.n_levels - 1):
        step = 2**l
        if (nz - 1) % (2 * step) or (nr - 1) % (2 * step):
            raise ValueError(
                f"grid {nz}x{nr} not coarsenable {config.n_levels - 1} times; "
                "choose nz-1, nr-1 divisible by 2^(n_levels-1)"
            )
    levels = []
    C = C_fine if C_fine is not None else assemble_stencil_2d(coords, sigma_cells, free_mask)
    for l in range(config.n_levels):
        diag = stencil_diag(C)
        inv_diag = 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag))
        precond = _make_precond(C, inv_diag, config.smoother, config.line_max_steps)
        levels.append(
            {
                "C": C,
                "inv_diag": inv_diag,
                "free": free_mask,
                "precond": precond,
                "apply": make_stencil_apply(C, l < config.kernel_levels),
                "lmax": _estimate_lmax(C, precond, config.power_iters),
            }
        )
        if l < config.n_levels - 1:
            free_mask = free_mask[..., ::2, ::2]
            C = galerkin_coarsen(C, free_mask)
    return levels


def v_cycle(levels, r, config: MGConfig, l: int = 0):
    """One V-cycle approximating A^{-1} r (zero initial guess)."""
    level = levels[l]
    free = level["free"]
    freeb = free if r.ndim == free.ndim else free.unsqueeze(-3)
    if l == len(levels) - 1:
        return _chebyshev_smooth(
            level, r, torch.zeros_like(r), config.coarse_degree, config.lower_frac / 8
        )
    z = _chebyshev_smooth(level, r, torch.zeros_like(r), config.degree_pre, config.lower_frac)
    res = r - level["apply"](z)
    res = torch.where(freeb, res, torch.zeros_like(res))
    zc = v_cycle(levels, restrict(res), config, l + 1)
    pz = prolong(zc)
    z = z + torch.where(freeb, pz, torch.zeros_like(pz))
    z = _chebyshev_smooth(level, r, z, config.degree_post, config.lower_frac)
    return z


def make_mg_preconditioner(
    coords, sigma_cells, free_mask, config: MGConfig = MGConfig(), C_fine=None
):
    """Returns (C_fine, M_inv) for use with :func:`remo3d_tpu_torch.ops.cg.pcg`."""
    levels = build_hierarchy(coords, sigma_cells, free_mask, config, C_fine=C_fine)

    def M_inv(r):
        return v_cycle(levels, r, config)

    return levels[0]["C"], M_inv
