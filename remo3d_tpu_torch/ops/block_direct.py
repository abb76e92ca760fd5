# -*- coding: utf-8 -*-
"""Batched block-tridiagonal direct factorization of the 2D stencil operator.

Counterpart of ``remo3d_tpu.ops.block_direct``. The 9-point axisymmetric
stencil is block-tridiagonal over axial lines: line i couples only to lines
i±1, and every block is tridiagonal in the radial index. One batch's operator
serves all S solves of that batch, so one factorization per batch amortizes
over the solve axis.

Block-LDL^T (block Thomas): S_0 = D_0, S_i = D_i − L_i S_{i−1}^{-1} U_{i−1},
with U_i = L_{i+1}^T. G_i ≈ S_i^{-1} is stored explicitly (symmetrized), so
the apply consists of batched matrix products instead of triangular solves:

    forward   y_i = b_i − L_i (G_{i−1} y_{i−1})        (L_i tridiagonal: shifts)
    backward  x_i = G_i y_i − G_i (U_i x_{i+1})

With every G_i symmetric the operator applied is exactly L̃^{-T} diag(G) L̃^{-1}:
symmetric positive definite for any symmetric positive-definite G, so rounded
block inverses still give a valid PCG preconditioner, and CG controls the final
accuracy. The recurrences amplify per-entry error by about the condition of
the chain (~1e5 on the 761-line grid), so every product here runs in full
float32 (:func:`highest_matmul_precision`), never in TF32.

The JAX package's ``lax.scan`` over the lines is a Python loop over tensors
that stay on the device; nothing inside the loops reads a value back.
Selected with ``preconditioner="direct"``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def highest_matmul_precision(fn):
    """Run ``fn`` with float32 matrix products in full float32.

    On a CUDA card a float32 ``matmul`` runs in TF32 (10-bit mantissa) when the
    caller has set ``torch.set_float32_matmul_precision`` below "highest" or
    ``torch.backends.cuda.matmul.allow_tf32``; harmless for most of the
    solver, not for a direct factorization whose recurrences amplify per-entry
    error by ~1e5. The caller's setting is put back afterwards.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        before = torch.get_float32_matmul_precision()
        if before == "highest":
            return fn(*args, **kwargs)
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(before)

    return wrapped


def _sym_inv(S):
    """Batched inverse, symmetrized (the SPD guarantee of the preconditioner)."""
    G = torch.linalg.inv(S)
    return 0.5 * (G + G.transpose(-1, -2))


def _tri_diagonals_z(C):
    """Off-diagonal (z -> z+1) block diagonals u_d[k] = U_i[k, k+d], d in -1,0,1.

    C[b, z, r, di, dj] couples node (z, r) to (z+di-1, r+dj-1), so the
    coupling into the next line is the di=2 row of the stencil.
    """
    return C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]  # (B, NZ, NR) each


def _transpose_diagonals(u_m, u_0, u_p):
    """Diagonals of U^T from those of U: l_d[r] = U[r+d, r], zero outside."""
    return F.pad(u_p[..., :-1], (1, 0)), u_0, F.pad(u_m[..., 1:], (0, 1))


def _shift_lines(a):
    """a[:, i-1] at line i, zero at i = 0: U_{i-1} aligned to line i.
    a (B, NZ, ...)."""
    out = torch.zeros_like(a)
    out[:, 1:] = a[:, :-1]
    return out


def _tri_matmul_left(l_m, l_0, l_p, M):
    """T = L @ M for tridiagonal L given by its diagonals (rows of M mix).

    l_d[r] = L[r, r+d]; T[r, :] = l_m[r]*M[r-1, :] + l_0[r]*M[r, :] + l_p[r]*M[r+1, :].
    M: (..., NR, NR) dense; l_*: (..., NR).
    """
    T = l_0[..., None] * M
    T[..., 1:, :] += l_m[..., 1:, None] * M[..., :-1, :]
    T[..., :-1, :] += l_p[..., :-1, None] * M[..., 1:, :]
    return T


def _tri_matmul_right(M, u_m, u_0, u_p):
    """T = M @ U for tridiagonal U given by its diagonals (columns of M mix).

    u_d[k] = U[k, k+d]; T[:, c] = M[:, c+1]*u_m[c+1] + M[:, c]*u_0[c] + M[:, c-1]*u_p[c-1].
    """
    T = M * u_0[..., None, :]
    T[..., :-1] += M[..., 1:] * u_m[..., None, 1:]
    T[..., 1:] += M[..., :-1] * u_p[..., None, :-1]
    return T


def _tri_matvec(l_m, l_0, l_p, v):
    """w = L v for tridiagonal L diagonals over the last axis of v (..., NR)."""
    w = l_0 * v
    w[..., 1:] += l_m[..., 1:] * v[..., :-1]
    w[..., :-1] += l_p[..., :-1] * v[..., 1:]
    return w


def _dense_line_blocks(C):
    """Diagonal blocks D_i as dense (..., NR, NR) from the di=1 stencil row,
    with zero diagonal entries (padded batches / eliminated rows) promoted to
    1 so the factorization stays nonsingular. C (..., NR, 3, 3)."""
    d_m, d_0, d_p = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    d_0 = torch.where(d_0 == 0, torch.ones_like(d_0), d_0)
    return (
        torch.diag_embed(d_0)
        + torch.diag_embed(d_m[..., 1:], offset=-1)
        + torch.diag_embed(d_p[..., :-1], offset=1)
    )


@highest_matmul_precision
def schur_fixedpoint_factor(C, passes=8):
    """Batched fixed-point approximation of the block-LDL^T Schur inverses.

    The exact chain G_i = (D_i - L_i G_{i-1} U_{i-1})^{-1} is sequential
    (:func:`block_thomas_factor`: one small batched inversion per axial line).
    This variant iterates the same recurrence Jacobi-style over the whole
    stack at once,

        G^(0)_i = D_i^{-1},     G^(m)_i = (D_i - L_i G^(m-1)_{i-1} U_{i-1})^{-1},

    so every pass is one batched (B*NZ, NR, NR) inversion plus tridiagonal
    block products. After m passes G^(m)_i is exact for i <= m and equals the
    Schur inverse of the chain truncated m lines back otherwise; the
    truncation error decays like the operator's Green's function along z.

    Safety (Loewner-order induction): S_i(exact) <= D_i gives
    G^(0) = D^{-1} <= G_exact; congruence preserves order, so
    G^(m-1) <= G_exact implies S^(m) = D - L G^(m-1) L^T >= S_exact > 0 and
    G^(m) <= G_exact; likewise G^(m-1) >= G^(m-2) implies G^(m) >= G^(m-1).
    Every iterate is therefore SPD and increases monotonically toward the
    exact inverses: a valid PCG preconditioner at any pass count; ``passes``
    only trades CG iterations against factorization time. Returns the same
    (NZ, B, NR, NR) stack as :func:`block_thomas_factor` (the apply is shared).
    """
    D = _dense_line_blocks(C)  # (B, NZ, NR, NR)
    # U_{i-1} diagonals aligned to line i, and those of L_i = U_{i-1}^T.
    um_s, u0_s, up_s = (_shift_lines(a) for a in _tri_diagonals_z(C))
    l_m, l_0, l_p = _transpose_diagonals(um_s, u0_s, up_s)

    G = _sym_inv(D)
    for _ in range(passes):
        T = _tri_matmul_left(l_m, l_0, l_p, _shift_lines(G))  # L_i G_{i-1}
        G = _sym_inv(D - _tri_matmul_right(T, um_s, u0_s, up_s))
    return G.movedim(1, 0).contiguous()  # (NZ, B, NR, NR)


@highest_matmul_precision
def block_thomas_factor(C):
    """Factorize the block-tridiagonal stencil operator.

    C: (B, NZ, NR, 3, 3) Dirichlet-eliminated stencil. Returns the stacked
    symmetrized Schur-complement inverses G (NZ, B, NR, NR), in C's type.
    """
    B, nz, nr = C.shape[0], C.shape[1], C.shape[2]
    um_s, u0_s, up_s = (_shift_lines(a) for a in _tri_diagonals_z(C))
    l_m, l_0, l_p = _transpose_diagonals(um_s, u0_s, up_s)
    G_all = torch.empty((nz, B, nr, nr), dtype=C.dtype, device=C.device)
    G = torch.zeros((B, nr, nr), dtype=C.dtype, device=C.device)
    for i in range(nz):
        T = _tri_matmul_left(l_m[:, i], l_0[:, i], l_p[:, i], G)  # L_i G_{i-1}
        # S_i = D_i - L_i G_{i-1} U_{i-1}
        S = _dense_line_blocks(C[:, i]) - _tri_matmul_right(T, um_s[:, i], u0_s[:, i], up_s[:, i])
        G = _sym_inv(S)
        G_all[i] = G
    return G_all


@highest_matmul_precision
def block_thomas_apply(G_all, C, b):
    """x = M^{-1} b with the factorization from :func:`block_thomas_factor`.

    G_all: (NZ, B, NR, NR); C: (B, NZ, NR, 3, 3); b: (B, [S,] NZ, NR).
    Linear, SPD (see module docstring): a PCG preconditioner.
    """
    nz = C.shape[1]
    no_solve_axis = b.ndim == 3
    if no_solve_axis:
        b = b.unsqueeze(1)
    G_all = G_all.to(b.dtype)
    # z-major, diagonals broadcast over the solve axis: (NZ, B, 1, NR).
    u_m, u_0, u_p = (a.movedim(1, 0).unsqueeze(2) for a in _tri_diagonals_z(C))
    l_m, l_0, l_p = (
        a.movedim(1, 0).unsqueeze(2)
        for a in _transpose_diagonals(*(_shift_lines(a) for a in _tri_diagonals_z(C)))
    )
    bz = b.movedim(2, 0)  # (NZ, B, S, NR)

    # (B, S, NR) x (B, NR, NR)^T: G_i applied to every solve's line vector.
    def gmatvec(G, v):
        return torch.bmm(v, G.transpose(1, 2))

    # forward: y_i = b_i - L_i (G_{i-1} y_{i-1}); w_i = G_i y_i.
    w = torch.empty_like(bz)
    w_i = torch.zeros_like(bz[0])
    for i in range(nz):
        w_i = gmatvec(G_all[i], bz[i] - _tri_matvec(l_m[i], l_0[i], l_p[i], w_i))
        w[i] = w_i
    # backward: x_i = w_i - G_i (U_i x_{i+1})
    x = torch.empty_like(bz)
    x_i = torch.zeros_like(bz[0])
    for i in range(nz - 1, -1, -1):
        x_i = w[i] - gmatvec(G_all[i], _tri_matvec(u_m[i], u_0[i], u_p[i], x_i))
        x[i] = x_i
    x = x.movedim(0, 2)
    return (x[:, 0] if no_solve_axis else x).contiguous()
