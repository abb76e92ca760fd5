# -*- coding: utf-8 -*-
"""Batched banded-block-tridiagonal direct factorization of the 3D operator.

Counterpart of ``remo3d_tpu.ops.block_direct3d``. The 27-point stencil is
block-tridiagonal over axial planes: plane i couples only to planes i±1, with
blocks that are 9-point banded in the flattened (p, r) index. As in
:mod:`.block_direct` (2D), one batch's operator serves all S solves, so one
block-LDL^T per batch amortizes, and the Schur-complement inverses
G_i ≈ S_i^{-1} are formed explicitly (symmetrized, in full float32: the sweep
recurrences amplify storage error ~1e5x, see :mod:`.block_direct`), so the
preconditioner application is two sweeps of batched matrix products, and a
handful of direct-preconditioned CG iterations replace the ~10^2 of the ADI
line-CG.

The dense blocks never materialize outside the factorization loop: each step
builds D_i (B, NPR, NPR) from 9 coefficient planes, sandwiches
L_i G_{i-1} U_{i-1} with banded (9-offset) shifted products, inverts, and
stores one G_i. The memory held is G (NZ, B, NPR, NPR).

The banded products shift by slicing: row (or column) k pairs with k + off,
and the validity mask of :func:`_valid_rows` zeroes the pairs that would cross
an azimuth or radial edge of the plane (where a roll would wrap).

The coincident-axis (pole) DOFs stay untied here; callers wrap the apply in
``pole_project`` (the tied-subspace projection), under which P M^{-1} P is
symmetric positive semidefinite on the tied subspace: a valid CG
preconditioner. Selected with ``precond3d="direct"``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .block_direct import _shift_lines, _sym_inv, highest_matmul_precision
from .stencil3d import entry_index

# In-plane offsets (dz = 0), the diagonal among them.
_PLANE_OFFS = [(dp, dr) for dp in (-1, 0, 1) for dr in (-1, 0, 1)]


def _flat_offset(dp: int, dr: int, nr: int) -> int:
    return dp * nr + dr


def _valid_rows(np_: int, nr: int, dp: int, dr: int) -> np.ndarray:
    """(NPR,) mask: node (p, r) has an in-grid neighbor (p+dp, r+dr)."""
    p, r = np.divmod(np.arange(np_ * nr), nr)
    return (
        (p + dp >= 0) & (p + dp < np_) & (r + dr >= 0) & (r + dr < nr)
    ).astype(np.float32)


def _bands(np_: int, nr: int, like: torch.Tensor):
    """Per in-plane offset: (mask (NPR,), rows k, rows k + off) with the two
    slices covering every k for which k + off lies inside the plane. The masks
    have ``like``'s type and device."""
    return _bands_on(np_, nr, like.dtype, like.device)


@functools.lru_cache(maxsize=32)
def _bands_on(np_: int, nr: int, dtype, device):
    npr = np_ * nr
    out = []
    for dp, dr in _PLANE_OFFS:
        off = _flat_offset(dp, dr, nr)
        here = slice(max(0, -off), npr - max(0, off))
        there = slice(max(0, off), npr + min(0, off))
        mask = torch.as_tensor(_valid_rows(np_, nr, dp, dr), dtype=dtype, device=device)
        out.append((mask, here, there))
    return out


def _plane_coefs(C3, dz: int, np_: int, nr: int):
    """The 9 coefficient planes of the dz-row, flattened: list of (B, NZ, NPR)."""
    B, nz = C3.shape[0], C3.shape[1]
    return [
        C3[..., entry_index(dz, dp, dr)].reshape(B, nz, np_ * nr)
        for dp, dr in _PLANE_OFFS
    ]


def _transpose_coefs(coefs, nr: int):
    """Diagonals of U^T from the diagonals of U: the (dp,dr) diagonal of U^T is
    the (-dp,-dr) plane of U rolled by the flat offset (validity masks are
    applied where the diagonals are used)."""
    return [
        torch.roll(coefs[len(_PLANE_OFFS) - 1 - k], -_flat_offset(dp, dr, nr), dims=-1)
        for k, (dp, dr) in enumerate(_PLANE_OFFS)
    ]


def _dense_block(coefs_i, np_: int, nr: int, promote_diag: bool):
    """D = sum_d c_d * E_d with E_d the identity shifted by the flat offset,
    masked.

    coefs_i: list of 9 (..., NPR) planes. promote_diag turns a zero diagonal
    (padded batches, eliminated rows) into 1. Returns (..., NPR, NPR).
    """
    npr = np_ * nr
    c0 = coefs_i[0]
    out = torch.zeros(c0.shape + (npr,), dtype=c0.dtype, device=c0.device)
    for (dp, dr), (mask, here, _), c in zip(_PLANE_OFFS, _bands(np_, nr, c0), coefs_i):
        if promote_diag and dp == 0 and dr == 0:
            c = torch.where(c == 0, torch.ones_like(c), c)
        out.diagonal(_flat_offset(dp, dr, nr), -2, -1).add_((c * mask)[..., here])
    return out


def _banded_matmul_left(coefs_i, M, np_: int, nr: int):
    """T = L @ M with banded L: l_d[row]; T[row] = sum_d l_d[row] * M[row+off_d]."""
    out = torch.zeros_like(M)
    for (mask, here, there), l in zip(_bands(np_, nr, M), coefs_i):
        out[..., here, :] += (l * mask)[..., here, None] * M[..., there, :]
    return out


def _banded_matmul_right(M, coefs_i, np_: int, nr: int):
    """T = M @ U with banded U: u_d[k] = U[k, k+off_d];
    T[:, c] = sum_d M[:, c-off_d] * u_d[c-off_d]."""
    out = torch.zeros_like(M)
    for (mask, here, there), u in zip(_bands(np_, nr, M), coefs_i):
        out[..., there] += M[..., here] * (u * mask)[..., None, here]
    return out


def _banded_matvec(coefs_i, v, np_: int, nr: int):
    """w = L v, banded L as above; v (..., NPR), the diagonals broadcast
    against it."""
    out = torch.zeros_like(v)
    for (mask, here, there), l in zip(_bands(np_, nr, v), coefs_i):
        out[..., here] += (l * mask)[..., here] * v[..., there]
    return out


@highest_matmul_precision
def block_thomas_factor_3d(C3, np_: int, nr: int):
    """Factorize the banded-block-tridiagonal 27-point operator.

    C3: (B, NZ, NP, NR, 27) Dirichlet-eliminated stencil.
    Returns G (NZ, B, NPR, NPR), in C3's type.
    """
    B, nz = C3.shape[0], C3.shape[1]
    npr = np_ * nr
    diag = _plane_coefs(C3, 0, np_, nr)  # 9 x (B, NZ, NPR)
    # U_{i-1} diagonals aligned to plane i, and those of L_i = U_{i-1}^T.
    up_prev = [_shift_lines(c) for c in _plane_coefs(C3, 1, np_, nr)]
    l_prev = _transpose_coefs(up_prev, nr)
    G_all = torch.empty((nz, B, npr, npr), dtype=C3.dtype, device=C3.device)
    G = torch.zeros((B, npr, npr), dtype=C3.dtype, device=C3.device)
    for i in range(nz):
        D_i = _dense_block([c[:, i] for c in diag], np_, nr, promote_diag=True)
        T = _banded_matmul_left([c[:, i] for c in l_prev], G, np_, nr)
        G = _sym_inv(D_i - _banded_matmul_right(T, [c[:, i] for c in up_prev], np_, nr))
        G_all[i] = G
    return G_all


@highest_matmul_precision
def schur_fixedpoint_factor_3d(C3, np_: int, nr: int, passes=6, z_block=64):
    """Batched fixed-point approximation of the 3D Schur-inverse stack.

    Same construction (and the same Loewner-order SPD/monotonicity guarantee)
    as :func:`.block_direct.schur_fixedpoint_factor`: iterate
    G^(m)_i = (D_i - L_i G^(m-1)_{i-1} U_{i-1})^{-1} Jacobi-style from
    G^(0) = D^{-1}, so the factorization is ``passes`` batched inversions of
    the whole plane stack instead of one NZ-step chain of small inversions.
    After m passes the stack is exact for the first m planes and truncates
    the chain m planes back elsewhere; CG absorbs the (geometrically small)
    difference.

    The per-pass inversions run in groups of ``z_block`` planes to bound the
    inversion's workspace; two G-sized stacks are alive at once (the current
    and the previous pass), so callers sizing chunks against memory budget
    twice the storage of the exact chain. ``z_block`` = 64 was chosen on an H100
    with ``chip_smoke.py --tune-direct`` (less than half the factor time of 16
    at two batches of 193x17x49, PERF.md). Returns the same (NZ, B, NPR, NPR)
    stack; :func:`block_thomas_apply_3d` is shared.
    """
    B, nz = C3.shape[0], C3.shape[1]
    npr = np_ * nr
    # z-major coefficient planes (NZ, B, NPR), matching the stack's layout.
    diag = [c.movedim(1, 0) for c in _plane_coefs(C3, 0, np_, nr)]
    up_prev = [_shift_lines(c) for c in _plane_coefs(C3, 1, np_, nr)]
    l_prev = [c.movedim(1, 0) for c in _transpose_coefs(up_prev, nr)]
    up_prev = [c.movedim(1, 0) for c in up_prev]
    groups = [slice(z0, min(z0 + z_block, nz)) for z0 in range(0, nz, z_block)]

    G = torch.empty((nz, B, npr, npr), dtype=C3.dtype, device=C3.device)
    for g in groups:
        G[g] = _sym_inv(_dense_block([c[g] for c in diag], np_, nr, promote_diag=True))
    for _ in range(passes):
        G_new = torch.empty_like(G)
        for g in groups:
            G_prev = torch.zeros_like(G[g])  # G_{i-1} at plane i, zero at i = 0
            lo = max(g.start - 1, 0)
            G_prev[lo - (g.start - 1):] = G[lo : g.stop - 1]
            D = _dense_block([c[g] for c in diag], np_, nr, promote_diag=True)
            T = _banded_matmul_left([c[g] for c in l_prev], G_prev, np_, nr)
            G_new[g] = _sym_inv(D - _banded_matmul_right(T, [c[g] for c in up_prev], np_, nr))
        G = G_new
    return G


@highest_matmul_precision
def block_thomas_apply_3d(G_all, C3, b, np_: int, nr: int):
    """x = M^{-1} b. G_all: (NZ, B, NPR, NPR); b: (B, [S,] NZ, NP, NR)."""
    nz = C3.shape[1]
    npr = np_ * nr
    shape = b.shape
    b = b.reshape(shape[0], -1, nz, npr)  # (B, S, NZ, NPR)
    G_all = G_all.to(b.dtype)
    # z-major, diagonals broadcast over the solve axis: (NZ, B, 1, NPR).
    up = _plane_coefs(C3, 1, np_, nr)
    l_prev = [
        c.movedim(1, 0).unsqueeze(2)
        for c in _transpose_coefs([_shift_lines(c) for c in up], nr)
    ]
    up = [c.movedim(1, 0).unsqueeze(2) for c in up]
    bz = b.movedim(2, 0)  # (NZ, B, S, NPR)

    def gmatvec(G, v):  # (B, S, NPR) x (B, NPR, NPR)^T
        return torch.bmm(v, G.transpose(1, 2))

    # forward: y_i = b_i - L_i (G_{i-1} y_{i-1}); w_i = G_i y_i.
    w = torch.empty_like(bz)
    w_i = torch.zeros_like(bz[0])
    for i in range(nz):
        w_i = gmatvec(G_all[i], bz[i] - _banded_matvec([c[i] for c in l_prev], w_i, np_, nr))
        w[i] = w_i
    # backward: x_i = w_i - G_i (U_i x_{i+1})
    x = torch.empty_like(bz)
    x_i = torch.zeros_like(bz[0])
    for i in range(nz - 1, -1, -1):
        x_i = w[i] - gmatvec(G_all[i], _banded_matvec([c[i] for c in up], x_i, np_, nr))
        x[i] = x_i
    return x.movedim(0, 2).reshape(shape)
