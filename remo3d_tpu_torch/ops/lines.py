# -*- coding: utf-8 -*-
"""Line (tridiagonal) solvers on stencil operators: anisotropy-robust smoothing.

Counterpart of ``remo3d_tpu.ops.lines`` (2D). The boundary-fitted grids have cell
aspect ratios up to ~10^3, which defeats point smoothers; line relaxation solves
the strong-coupling direction exactly with PARALLEL CYCLIC REDUCTION: ceil(log2(n))
vectorized elimination levels of shifted multiply-adds, no sequential scan.

The multigrid smoother always uses the factored form (:func:`line_factor_2d` once
per level, :func:`line_apply_2d` per application): exact factored PCR and exact
in-line PCR (:func:`pcr_solve`) are the same algebra. A factorization is one
stacked tensor (alpha_k, beta_k per level, then the inverse reduced diagonal),
which on a CUDA device the line applies hand to the K3 kernel
(:mod:`remo3d_tpu_torch.kernels.pcr_lines`) whole; :func:`pcr_apply` is its
plain version.
"""

from __future__ import annotations

import math

import torch

from ..kernels import pcr_lines

# On CUDA tensors, apply the factored line solves (line_apply_2d, and
# lines3d.line_apply3) with the K3 kernel. False applies them with the plain
# pcr_apply on the card too: chip_smoke.py's runs with K3 off.
PCR_KERNEL = True

_LINE_AXES_2D = {  # direction -> ((dl sel, d sel, du sel), axis)
    "r": (((1, 0), (1, 1), (1, 2)), -1),
    "z": (((0, 1), (1, 1), (2, 1)), -2),
}


def _shift(x: torch.Tensor, s: int, axis: int, fill: float) -> torch.Tensor:
    """x[i - s] along ``axis`` (s may be negative), padding with ``fill``."""
    n = x.shape[axis]
    out = torch.full_like(x, fill)
    if abs(s) < n:
        if s >= 0:
            out.narrow(axis, s, n - s).copy_(x.narrow(axis, 0, n - s))
        else:
            out.narrow(axis, 0, n + s).copy_(x.narrow(axis, -s, n + s))
    return out


def _n_steps(n: int, max_steps: int | None) -> int:
    steps = max(1, math.ceil(math.log2(max(n, 2))))
    return steps if max_steps is None else min(steps, max_steps)


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d != 0, d, torch.ones_like(d))


def pcr_solve(dl, d, du, b, axis: int = 0, max_steps: int | None = None):
    """Solve tridiagonal systems along ``axis`` by parallel cyclic reduction.

    dl[i] = A[i, i-1] (dl[0] ignored), d[i] = A[i, i], du[i] = A[i, i+1]
    (du[-1] ignored). Batched over every other axis. ``max_steps`` truncates the
    reduction (approximate solve within a 2^max_steps window).
    """
    a, c, x = dl, du, b
    s = 1
    for _ in range(_n_steps(d.shape[axis], max_steps)):
        # Virtual out-of-range rows are identity: a=c=0, b(diag)=1, rhs=0.
        alpha = -a / _safe(_shift(d, s, axis, 1.0))
        beta = -c / _safe(_shift(d, -s, axis, 1.0))
        a_m, c_m, x_m = (_shift(v, s, axis, 0.0) for v in (a, c, x))
        a_p, c_p, x_p = (_shift(v, -s, axis, 0.0) for v in (a, c, x))
        a = alpha * a_m
        c = beta * c_p
        d = d + alpha * c_m + beta * a_p
        x = x + alpha * x_m + beta * x_p
        s *= 2
    return x / _safe(d)


def pcr_factor(dl, d, du, axis: int = 0, max_steps: int | None = None):
    """Precompute the PCR elimination coefficients of a tridiagonal operator.

    The (alpha, beta) multipliers and the final reduced diagonal depend only on
    the matrix, not on the right-hand side, so the elimination algebra is hoisted
    out of every apply. Returns ``(steps, dinv)`` with steps a list of
    (alpha, beta) per reduction level: views into the one tensor of
    :func:`pcr_factor_stacked`.
    """
    return split_factors(pcr_factor_stacked(dl, d, du, axis, max_steps), 0)


def pcr_factor_stacked(dl, d, du, axis: int = 0, max_steps: int | None = None,
                       stack_dim: int = 0) -> torch.Tensor:
    """:func:`pcr_factor`'s levels written into one contiguous tensor: dl's
    shape with 2L+1 planes inserted at ``stack_dim``, alpha_0, beta_0, ...,
    alpha_{L-1}, beta_{L-1}, then dinv; each plane is written where it is
    computed, with the arithmetic of the per-level list."""
    n_levels = _n_steps(d.shape[axis], max_steps)
    shape = list(dl.shape)
    shape.insert(stack_dim if stack_dim >= 0 else len(shape) + 1 + stack_dim, 2 * n_levels + 1)
    F = torch.empty(shape, dtype=torch.result_type(dl, d), device=dl.device)
    planes = F.unbind(stack_dim)
    a, c = dl, du
    s = 1
    for k in range(n_levels):
        alpha = torch.div(-a, _safe(_shift(d, s, axis, 1.0)), out=planes[2 * k])
        beta = torch.div(-c, _safe(_shift(d, -s, axis, 1.0)), out=planes[2 * k + 1])
        a_m, c_m = _shift(a, s, axis, 0.0), _shift(c, s, axis, 0.0)
        a_p, c_p = _shift(a, -s, axis, 0.0), _shift(c, -s, axis, 0.0)
        a = alpha * a_m
        c = beta * c_p
        d = d + alpha * c_m + beta * a_p
        s *= 2
    torch.reciprocal(_safe(d), out=planes[-1])  # what 1.0 / d computes
    return F


def split_factors(F: torch.Tensor, stack_dim: int):
    """(steps, dinv) of a :func:`pcr_factor_stacked` tensor, as views."""
    planes = F.unbind(stack_dim)
    return [(planes[2 * k], planes[2 * k + 1]) for k in range(len(planes) // 2)], planes[-1]


def pcr_apply(steps, dinv, b, axis: int = 0):
    """Apply a :func:`pcr_factor` factorization to (batched) right-hand sides.

    Each level is x + alpha*x[i-s] + beta*x[i+s] (zero outside the line), written
    as two in-place adds of products on the in-range windows of a fresh copy,
    each product and sum rounded on its own (no fused multiply-add), as the
    CUDA kernel K3 rounds them.
    """
    x = b
    s = 1
    for alpha, beta in steps:
        n = x.shape[axis]
        if s < n:
            m = n - s
            nxt = x.clone()
            nxt.narrow(axis, s, m).add_(alpha.narrow(axis, s, m) * x.narrow(axis, 0, m))
            nxt.narrow(axis, 0, m).add_(beta.narrow(axis, 0, m) * x.narrow(axis, s, m))
            x = nxt
        s *= 2
    return x * dinv


def line_factor_2d(C, direction: str, max_steps=None):
    """Factorize the tridiagonal line part of the 9-pt stencil along r or z.

    Computed once per assembled operator; the coefficients are per batch, not per
    solve, so the elimination algebra is amortized over the solve axis too.
    Returns (axis, F): F the stacked factors, C's batch shape + (2L+1, NZ, NR).
    """
    (lo, mid, hi), axis = _LINE_AXES_2D[direction]
    F = pcr_factor_stacked(
        C[..., lo[0], lo[1]],
        C[..., mid[0], mid[1]],
        C[..., hi[0], hi[1]],
        axis=axis,
        max_steps=max_steps,
        stack_dim=-3,
    )
    return axis, F


def line_apply_2d(factors, b):
    """Apply a :func:`line_factor_2d` factorization to b, (B, NZ, NR) or with
    a solve axis (B, S, NZ, NR): on a CUDA device one K3 launch (with
    :data:`PCR_KERNEL`), else :func:`pcr_apply`."""
    axis, F = factors
    apply_ = pcr_lines.pcr_apply_lines if PCR_KERNEL else pcr_lines.pcr_apply_lines_plain
    return apply_(F, b, axis)


def _line_solve(C, b, direction: str, max_steps=None):
    (lo, mid, hi), axis = _LINE_AXES_2D[direction]
    Cb = C if b.ndim == C.ndim - 2 else C.unsqueeze(-5)
    dl, d, du = (Cb[..., i, j].expand(b.shape) for i, j in (lo, mid, hi))
    return pcr_solve(dl, d, du, b, axis=axis, max_steps=max_steps)


def line_solve_r(C, b, max_steps=None):
    """Solve the radial-line tridiagonal part: couplings (1,0),(1,1),(1,2).

    C: (..., NZ, NR, 3, 3); b: (..., [S,] NZ, NR). Solves along the NR axis for
    every z-line independently.
    """
    return _line_solve(C, b, "r", max_steps)


def line_solve_z(C, b, max_steps=None):
    """Solve the axial-line tridiagonal part: couplings (0,1),(1,1),(2,1)."""
    return _line_solve(C, b, "z", max_steps)
