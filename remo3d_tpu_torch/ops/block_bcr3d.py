# -*- coding: utf-8 -*-
"""Block cyclic reduction for the 3D operator: log-depth factor and apply.

Counterpart of ``remo3d_tpu.ops.block_bcr3d``. The 27-point stencil is
block-tridiagonal over axial planes with 9-point-banded (NPR x NPR) blocks
(see :mod:`.block_direct3d`). The sequential block-LDL^T chain factors it in
NZ dependent steps and applies it with two NZ-step loops per CG iteration;
cyclic reduction replaces both with ``log2(NZ)`` batched stages of dense
products.

Level 0 is specialized to the banded structure: the odd-plane diagonal blocks
are densified and inverted in groups of ``z_block`` planes (to bound the
inversion's workspace), and the Schur products U G U^T / U^T G U / U G U use
the shifted-diagonal banded helpers instead of materializing dense U. The
reduced even-plane system has dense blocks and is handed to the generic dense
recursion (:func:`.block_bcr.bcr_factor_dense`).

Storage: the level-0 G (NZ/2 dense blocks) plus the dense levels (~NZ/2 G and
~NZ/2 U'), about 1.5x the chain's; the factorization also holds several
half-stacks of products at once, so callers cap 3D chunks accordingly
(``parallel/runtime.py``). SPD is preserved at every level (block Gaussian
elimination under a symmetric permutation, symmetrized inverses).
Selected with ``precond3d="direct"`` and ``direct_schedule="bcr"``.
"""

from __future__ import annotations

import torch

from .block_bcr import _bcr_solve, bcr_factor_dense
from .block_direct import _sym_inv, highest_matmul_precision
from .block_direct3d import (
    _banded_matmul_left,
    _banded_matmul_right,
    _banded_matvec,
    _dense_block,
    _plane_coefs,
    _transpose_coefs,
)


def _sym_inv_blocked(S, z_block: int):
    """Batched symmetrized inverse, in groups over the plane axis to bound the
    LU workspace: S (B, m, N, N)."""
    G = torch.empty_like(S)
    for k in range(0, S.shape[1], z_block):
        G[:, k : k + z_block] = _sym_inv(S[:, k : k + z_block])
    return G


@highest_matmul_precision
def bcr_factor_3d(C3, np_: int, nr: int, z_block: int = 32):
    """Factorize the banded-block-tridiagonal 27-point operator by cyclic
    reduction. C3: (B, NZ, NP, NR, 27) Dirichlet-eliminated stencil.

    Returns ``(lvl0, dense_factors)``: level-0 (G_odd, Ue_coefs, Uo_coefs)
    with banded couplings kept as 9 coefficient planes, and the dense
    recursion factors of the even-plane Schur system. ``z_block`` = 32 was
    chosen on an H100 at (8, 193, 17, 49) with ``chip_smoke.py --tune-direct``:
    the least factor time of 4 to 96, at the same peak memory (PERF.md).
    """
    diag = _plane_coefs(C3, 0, np_, nr)  # 9 x (B, NZ, NPR)
    up = _plane_coefs(C3, 1, np_, nr)  # U_i, i = 0..NZ-2 valid (last plane unused)

    ue = [c[:, 0:-1:2] for c in up]  # U_{2k}, k = 0..mo-1
    uo = [c[:, 1:-1:2] for c in up]  # U_{2k+1}
    n_uo = uo[0].shape[1]

    D_odd = _dense_block([c[:, 1::2] for c in diag], np_, nr, promote_diag=True)
    G = _sym_inv_blocked(D_odd, z_block)  # (B, mo, NPR, NPR)
    del D_odd
    mo = G.shape[1]

    # Schur products with banded couplings: right_k = U_{2k} G_k U_{2k}^T,
    # left_k = U_{2k+1}^T G_k U_{2k+1}, U'_k = -U_{2k} G_k U_{2k+1}.
    D1 = _dense_block([c[:, 0::2] for c in diag], np_, nr, promote_diag=True)
    UeG = _banded_matmul_left(ue, G, np_, nr)  # U_{2k} G_k
    D1[:, :mo] -= _banded_matmul_right(UeG, _transpose_coefs(ue, nr), np_, nr)
    UoTG = _banded_matmul_left(_transpose_coefs(uo, nr), G[:, :n_uo], np_, nr)  # U^T G
    D1[:, 1 : 1 + n_uo] -= _banded_matmul_right(UoTG, uo, np_, nr)
    del UoTG
    U1 = -_banded_matmul_right(UeG[:, :n_uo], uo, np_, nr)
    del UeG

    dense_factors = bcr_factor_dense(D1, U1)
    lvl0 = (G, [c.contiguous() for c in ue], [c.contiguous() for c in uo])
    return lvl0, dense_factors


@highest_matmul_precision
def bcr_apply_3d(factors, b, np_: int, nr: int):
    """x = M^{-1} b. b: (B, [S,] NZ, NP, NR); exact inverse at float32 rounding.

    The coincident-axis (pole) DOFs stay untied here; callers wrap in
    ``pole_project`` as for the chain's apply."""
    (G, ue, uo), dense_factors = factors
    dtype = b.dtype
    shape = b.shape
    nz, npr = shape[-3], np_ * nr
    # Plane-major inside: (B, m, S, NPR), so a block acts on all solves of its plane.
    bz = b.reshape(shape[0], -1, nz, npr).transpose(1, 2)
    mo, n_uo = G.shape[1], uo[0].shape[1]
    G = G.to(dtype)

    def gmv(v):  # G_k on (B, mo, S, NPR)
        return v @ G.transpose(-1, -2)

    def umv(coefs, v):  # banded coupling on per-plane vectors
        return _banded_matvec([c.to(dtype).unsqueeze(2) for c in coefs], v, np_, nr)

    b_o = bz[:, 1::2]
    w = gmv(b_o)
    b_e = bz[:, 0::2].clone()
    b_e[:, 1 : 1 + n_uo] -= umv(_transpose_coefs(uo, nr), w[:, :n_uo])
    b_e[:, :mo] -= umv(ue, w)
    x_e = _bcr_solve(dense_factors, b_e)
    t = b_o - umv(_transpose_coefs(ue, nr), x_e[:, :mo])
    t[:, :n_uo] -= umv(uo, x_e[:, 1 : 1 + n_uo])
    x = torch.empty_like(bz)
    x[:, 0::2] = x_e
    x[:, 1::2] = gmv(t)
    return x.transpose(1, 2).reshape(shape)
