# -*- coding: utf-8 -*-
"""Batched preconditioned conjugate gradients on stencil operators.

Counterpart of ``remo3d_tpu.ops.cg``. All solves in the batch run lock-step;
converged and empty lanes are frozen by masking, so padded measurement slots cost
nothing numerically, and the loop ends when every lane is done. The JAX package's
``lax.while_loop`` becomes a Python loop that reads the any-lane-active flag back
from the device once per iteration: one host sync per iteration, and in exchange
the iteration count equals the JAX package's exactly.
"""

from __future__ import annotations

from typing import Callable

import torch

from .stencil import stencil_apply, stencil_diag


def pcg(
    C: torch.Tensor | None,
    b: torch.Tensor,
    M_inv: Callable[[torch.Tensor], torch.Tensor] | None = None,
    tol: float = 1e-7,
    maxiter: int = 1000,
    n_grid_axes: int = 2,
    matvec: Callable[[torch.Tensor], torch.Tensor] | None = None,
):
    """Solve A u = b with A given by stencil C, for batched right-hand sides.

    C (..., NZ, NR, 3, 3), b (..., [S,] NZ, NR); or a custom ``matvec`` and
    ``M_inv``. Returns (u, info); info = dict(iterations (int), rel_residual)
    with rel_residual of b's batch shape.
    """
    axes = tuple(range(-n_grid_axes, 0))

    def _dot(a, c):
        return torch.sum(a * c, dim=axes)

    if matvec is None:
        matvec = lambda u: stencil_apply(C, u)  # noqa: E731

    if M_inv is None:
        diag = stencil_diag(C)
        if b.ndim == C.ndim - n_grid_axes + 1:  # solve axis present
            diag = diag.unsqueeze(-(n_grid_axes + 1))
        safe_diag = torch.where(diag != 0, diag, torch.ones_like(diag))
        M_inv = lambda r: r / safe_diag  # noqa: E731

    def _bc(s):  # broadcast a batch scalar over the grid axes
        return s[(...,) + (None,) * n_grid_axes]

    b_norm2 = _dot(b, b)
    active0 = b_norm2 > 0
    ones = torch.ones_like(b_norm2)
    tol2 = (tol * tol) * torch.where(active0, b_norm2, ones)

    u = torch.zeros_like(b)
    r = b
    p = M_inv(r)
    rz = _dot(r, p)
    k = 0
    while k < maxiter:
        rr = _dot(r, r)
        not_done = active0 & (rr > tol2)
        if not bool(not_done.any()):
            break
        Ap = matvec(p)
        pAp = _dot(p, Ap)
        live = not_done & (pAp > 0)
        alpha = torch.where(live, rz / torch.where(pAp > 0, pAp, ones), 0.0)
        u = u + _bc(alpha) * p
        r = r - _bc(alpha) * Ap
        z = M_inv(r)
        rz_new = _dot(r, z)
        beta = torch.where(live, rz_new / torch.where(rz > 0, rz, ones), 0.0)
        p = z + _bc(beta) * p
        # Freeze rz on finished lanes so their (masked) updates stay benign.
        rz = torch.where(live, rz_new, rz)
        k += 1
    rel = torch.sqrt(_dot(r, r) / torch.where(active0, b_norm2, ones))
    return u, {"iterations": k, "rel_residual": rel}
