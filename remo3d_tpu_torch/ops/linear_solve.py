# -*- coding: utf-8 -*-
"""A stencil linear solve with a custom gradient.

Counterpart of ``lax.custom_linear_solve(matvec, b, solve, symmetric=True)`` as
the JAX package's ``diff.py`` uses it: the solution ``w = A^{-1} b`` of a
symmetric stencil operator, given by its half-storage coefficients, is
differentiable in the coefficients and in ``b`` without autograd ever seeing
the CG loop or the preconditioner:

* forward: :func:`~remo3d_tpu_torch.ops.cg.pcg` with the K1 (2D) or pole-tied
  K2 (3D) matvec and a detached preconditioner apply;
* reverse: ``lam = A^{-1} g`` by the same PCG with the same preconditioner (one
  extra solve), then ``grad_b = lam`` and ``grad_C_half = -<lam, dA w>``, the
  kernels' coefficient contraction;
* forward mode: :func:`solve_tangents` solves ``A dw = db - dA w`` for every
  tangent of a chunk at once, as extra right-hand-side lanes of one PCG call
  that shares the factorization (what ``jax.jacfwd`` over
  ``custom_linear_solve`` does).

The operator is told apart by the rank of the right-hand side: (B, S, NZ, NR)
is the 2D operator A, (B, S, NZ, NP, NR) the 3D pole-tied operator P A P with
P = ``pole_project``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from ..kernels.stencil2d import stencil_apply_half_2d, stencil_half_coeff_grad_2d
from ..kernels.stencil3d import stencil3d_apply_half, stencil_half_coeff_grad_3d
from .cg import pcg
from .stencil3d import pole_project


def _dim(x: torch.Tensor) -> int:
    if x.ndim not in (4, 5):
        raise ValueError(f"expected (B, S, NZ, NR) or (B, S, NZ, NP, NR), got {tuple(x.shape)}")
    return x.ndim - 2


def _apply(C_half, x):
    if x.ndim == 4:
        return stencil_apply_half_2d(C_half, x)
    return stencil3d_apply_half(C_half, x, pole=True)


def _coeff_grad(g, x):
    if x.ndim == 4:
        return stencil_half_coeff_grad_2d(g, x)
    return stencil_half_coeff_grad_3d(g, x, pole=True)


def _pcg(C_half, b, M_inv, tol, maxiter):
    return pcg(None, b, M_inv=M_inv, tol=tol, maxiter=maxiter, n_grid_axes=_dim(b),
               matvec=lambda x: _apply(C_half, x))


class _LinearSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, C_half, rhs, M_inv, tol, maxiter, info):
        w, res = _pcg(C_half, rhs, M_inv, tol, maxiter)
        info["iterations"] = res["iterations"]
        info["worst_residual"] = float(res["rel_residual"].max())
        ctx.save_for_backward(C_half, w)
        ctx.solve = (M_inv, tol, maxiter, info)
        return w

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        C_half, w = ctx.saved_tensors
        M_inv, tol, maxiter, info = ctx.solve
        g = g.contiguous()
        if g.ndim == 5:  # the adjoint of the solve on the tied subspace
            g = pole_project(g)
        lam, res = _pcg(C_half, g, M_inv, tol, maxiter)
        info["adjoint_iterations"] = info.get("adjoint_iterations", 0) + res["iterations"]
        grad_C = -_coeff_grad(lam, w) if ctx.needs_input_grad[0] else None
        grad_rhs = lam if ctx.needs_input_grad[1] else None
        return grad_C, grad_rhs, None, None, None, None


def linear_solve(
    C_half: torch.Tensor,
    rhs: torch.Tensor,
    M_inv: Callable[[torch.Tensor], torch.Tensor],
    *,
    tol: float,
    maxiter: int,
    info: dict | None = None,
) -> torch.Tensor:
    """w = A^{-1} rhs, differentiable in ``C_half`` and ``rhs``.

    C_half: (B, 5, NZ, NR) or (B, 14, NZ, NP, NR) half storage of the
    (Dirichlet-eliminated) operator; rhs: (B, S, NZ, NR) or (B, S, NZ, NP, NR),
    in 3D already pole-projected. ``M_inv`` is the preconditioner apply; it
    must hold no tensor that requires a gradient (build it from a detached
    operator under ``torch.no_grad()``). ``info``, if a dict, gets the forward
    solve's ``iterations`` and ``worst_residual`` (the largest relative
    residual of its lanes) and, once a backward pass has
    run, its ``adjoint_iterations``.
    """
    return _LinearSolve.apply(C_half, rhs, M_inv, tol, maxiter, {} if info is None else info)


@torch.no_grad()
def solve_tangents(
    C_half: torch.Tensor,
    dC_half: torch.Tensor,
    d_rhs: torch.Tensor,
    w: torch.Tensor,
    M_inv: Callable[[torch.Tensor], torch.Tensor],
    *,
    tol: float,
    maxiter: int,
    info: dict | None = None,
) -> torch.Tensor:
    """Tangents of ``w = A^{-1} rhs`` for P directions at once.

    dC_half (P, B, n_half, *grid) and d_rhs (P, B, S, *grid) are the tangents of
    the coefficients and of the right-hand side, w (B, S, *grid) the forward
    solution. ``dA w`` is one kernel launch with the P tangent coefficient sets
    as batch lanes; then ``A dw = d_rhs - dA w`` is one PCG call on (B, P*S,
    *grid) right-hand sides sharing ``M_inv``. Returns dw (P, B, S, *grid).
    ``info``, if a dict, gets the solve's ``tangent_iterations``.
    """
    P, B, S = d_rhs.shape[:3]
    grid = tuple(w.shape[2:])
    lanes = w.unsqueeze(0).expand(P, *w.shape).reshape(P * B, S, *grid)
    dAw = _apply(dC_half.reshape(P * B, *dC_half.shape[2:]).contiguous(), lanes)
    b = (d_rhs - dAw.reshape(P, B, S, *grid)).transpose(0, 1).reshape(B, P * S, *grid)
    dw, res = _pcg(C_half, b.contiguous(), M_inv, tol, maxiter)
    if info is not None:
        info["tangent_iterations"] = res["iterations"]
    return dw.reshape(B, P, S, *grid).transpose(0, 1)
