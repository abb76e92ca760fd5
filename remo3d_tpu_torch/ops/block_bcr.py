# -*- coding: utf-8 -*-
"""Block cyclic reduction: log-depth exact factorization of the 2D operator.

Counterpart of ``remo3d_tpu.ops.block_bcr``. Same block-tridiagonal system as
:mod:`.block_direct` (the 9-point stencil over axial lines), factorized by
cyclic reduction instead of the sequential block-LDL^T chain: eliminate the
odd-numbered lines (their diagonal blocks invert independently, in one batched
inverse over all of them), which yields a half-size block-tridiagonal system
over the even lines; recurse. Both the factorization and every application are
``log2(NZ)`` batched stages of dense products, against the chain's NZ
sequential steps (factor) and two NZ-step loops per CG iteration (apply).

Math (exact block Gaussian elimination on a symmetric permutation; SPD is
preserved, no pivoting needed for SPD input): with D_i the diagonal blocks
and U_i the i->i+1 coupling (U_{i-1}^T couples i->i-1), eliminating odd i
gives, for even j,

    D'_j = D_j - U_{j-1}^T G_{j-1} U_{j-1} - U_j G_{j+1} U_j^T
    U'_j = -U_j G_{j+1} U_{j+1},          G_odd = D_odd^{-1}  (batched)
    b'_j = b_j - U_{j-1}^T (G b)_{j-1} - U_j (G b)_{j+1}
    x_odd = G ( b_odd - U_{j-1}^T x_{j-1} - U_j x_{j+1} )

Stored per level: symmetrized G_odd and the level's off-diagonals. Handles any
NZ (no power-of-two padding) through slice guards. Storage is about twice the
LDL^T chain's (the G stacks of all levels plus dense off-diagonals).
Selected with ``preconditioner="direct"`` and ``direct_schedule="bcr"``.
"""

from __future__ import annotations

import torch

from .block_direct import (
    _dense_line_blocks,
    _sym_inv,
    _tri_diagonals_z,
    highest_matmul_precision,
)


def _dense_U(C):
    """Densify the i->i+1 coupling blocks: (B, NZ-1, NR, NR).

    U_i[r, r+d] = u_d[i, r] from the di=2 stencil row (see block_direct).
    """
    u_m, u_0, u_p = (a[:, :-1] for a in _tri_diagonals_z(C))
    return (
        torch.diag_embed(u_0)
        + torch.diag_embed(u_m[..., 1:], offset=-1)
        + torch.diag_embed(u_p[..., :-1], offset=1)
    )


@highest_matmul_precision
def bcr_factor(C):
    """Cyclic-reduction factorization of the block-tridiagonal stencil operator.

    C: (B, NZ, NR, 3, 3) Dirichlet-eliminated stencil. Returns
    ``(levels, G_root)``: per level (G_odd, U_even, U_odd) and the final
    single-block inverse, as :func:`bcr_apply` takes them.
    """
    return bcr_factor_dense(_dense_line_blocks(C), _dense_U(C))


@highest_matmul_precision
def bcr_factor_dense(D, U):
    """Generic dense-block cyclic reduction (any block size; the 3D solver
    uses it for levels >= 1 after a banded level-0 elimination,
    :mod:`.block_bcr3d`).

    D: (B, m, N, N) diagonal blocks; U: (B, m-1, N, N) i->i+1 couplings.
    """
    levels = []
    m = D.shape[1]
    while m > 1:
        Ue = U[:, 0::2]  # U_{2k}, k = 0..mo-1
        Uo = U[:, 1::2]  # U_{2k+1}
        G = _sym_inv(D[:, 1::2])  # odd diagonal blocks
        mo, n_uo = G.shape[1], Uo.shape[1]

        right = Ue @ (G @ Ue.transpose(-1, -2))  # U_{2k} G_k U_{2k}^T -> D_e[k], k < mo
        GUo = G[:, :n_uo] @ Uo  # G_k U_{2k+1}
        left = Uo.transpose(-1, -2) @ GUo  # U^T G U -> D_e[k+1]
        D = D[:, 0::2].clone()
        D[:, :mo] -= right
        D[:, 1 : 1 + n_uo] -= left
        del right, left
        U = -(Ue[:, :n_uo] @ GUo)  # (B, me-1, N, N)
        levels.append((G, Ue.contiguous(), Uo.contiguous()))
        m = D.shape[1]
    G_root = _sym_inv(D)  # (B, 1, N, N)
    return tuple(levels), G_root


@highest_matmul_precision
def bcr_apply(factors, b):
    """x = M^{-1} b via the cyclic-reduction factorization (log-depth, exact).

    factors: from :func:`bcr_factor`. b: (B, [S,] NZ, NR). Linear and SPD
    (symmetrized G blocks, symmetric elimination): a valid PCG preconditioner
    and, at float32 rounding, an essentially exact inverse.
    """
    no_solve_axis = b.ndim == 3
    if no_solve_axis:
        b = b.unsqueeze(1)
    # Line-major inside: (B, m, S, NR), so a block acts on all solves of its line.
    x = _bcr_solve(factors, b.transpose(1, 2)).transpose(1, 2)
    return (x[:, 0] if no_solve_axis else x).contiguous()


def _blocks_on(M, v, transpose=False):
    """Blocks M (B, k, N, N) applied to the vectors v (B, k, S, N): M v, or
    M^T v with ``transpose``."""
    M = M.to(v.dtype)
    return v @ (M if transpose else M.transpose(-1, -2))


def _bcr_solve(factors, b):
    """The reduction and back-substitution of :func:`bcr_apply` on
    b (B, m, S, N); returns x alike. Two loops over the levels rather than a
    recursion, so that nothing but the caller holds the factors."""
    levels, G_root = factors
    odd_loads = []
    for G, Ue, Uo in levels:  # down: eliminate the odd lines of each level
        mo, n_uo = G.shape[1], Uo.shape[1]
        b_o = b[:, 1::2]
        w = _blocks_on(G, b_o)
        # b'_e[k] = b_e[k] - U_{2k-1}^T w[k-1] - U_{2k} w[k]
        b = b[:, 0::2].clone()
        b[:, 1 : 1 + n_uo] -= _blocks_on(Uo, w[:, :n_uo], transpose=True)
        b[:, :mo] -= _blocks_on(Ue, w)
        odd_loads.append(b_o)
    x = _blocks_on(G_root, b)
    for (G, Ue, Uo), b_o in zip(reversed(levels), reversed(odd_loads)):  # up
        mo, n_uo = G.shape[1], Uo.shape[1]
        # x_o[k] = G[k] (b_o[k] - U_{2k}^T x_e[k] - U_{2k+1} x_e[k+1])
        t = b_o - _blocks_on(Ue, x[:, :mo], transpose=True)
        t[:, :n_uo] -= _blocks_on(Uo, x[:, 1 : 1 + n_uo])
        x_e = x
        x = x_e.new_empty((x_e.shape[0], x_e.shape[1] + mo) + tuple(x_e.shape[2:]))
        x[:, 0::2] = x_e
        x[:, 1::2] = _blocks_on(G, t)
    return x
