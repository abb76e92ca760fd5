# -*- coding: utf-8 -*-
"""The reference's linear algebra: a direct block-tridiagonal solve of the
assembled stencil system, in plain torch.

The unknowns of one grid are ordered plane by plane along z (a row of NR nodes
in 2D, an (NP, NR) plane in 3D), so the stencil's operator is block
tridiagonal: one dense block per plane and its couplings to the planes above
and below. The solve is the block Thomas algorithm, exact up to rounding, with
every right-hand side of a batch at once. In 3D the axis nodes of one plane
(radial station 0, one copy per azimuth) are one physical node: the solve
works on the reduced unknowns y with w = Q y, Q^T A Q y = Q^T b, which is the
system the pole-tied operator P A P solves on the tied subspace.

``precision`` selects the arithmetic: "float64" (the reference), or "tf32",
the control, in float32 with both operands of every matrix product rounded
to TF32's 10-bit mantissa, as the card's TF32 tensor cores round them.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32")


def working_dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: use one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _tf32(a) @ _tf32(b)
    return a @ b


def tridiag_blocks_2d(C: torch.Tensor):
    """The three blocks of each z-row of a 9-point stencil C (B, NZ, NR, 3, 3):
    (lower, diagonal, upper), each (B, NZ, NR, NR); C[..., i, j, di, dj] couples
    node (i, j) to (i + di - 1, j + dj - 1)."""

    def band(c3):  # (..., NR, 3) -> (..., NR, NR)
        return (torch.diag_embed(c3[..., 1]) + torch.diag_embed(c3[..., :-1, 2], 1)
                + torch.diag_embed(c3[..., 1:, 0], -1))

    return band(C[..., 0, :]), band(C[..., 1, :]), band(C[..., 2, :])


def plane_blocks_3d(Ci: torch.Tensor, np_: int, nr: int):
    """The blocks of one z-plane of a 27-point stencil (entry
    e = ((dz+1)*3+(dp+1))*3+dr+1): Ci (B, NP, NR, 27) -> (lower, diagonal,
    upper), each (B, NP*NR, NP*NR), node (p, r) at p*NR + r."""
    B = Ci.shape[0]
    n = np_ * nr
    p = torch.arange(np_, device=Ci.device).repeat_interleave(nr)
    r = torch.arange(nr, device=Ci.device).repeat(np_)
    rows = torch.arange(n, device=Ci.device)
    flat = Ci.reshape(B, n, 27)
    blocks = []
    for dz in (-1, 0, 1):
        M = torch.zeros((B, n, n), dtype=Ci.dtype, device=Ci.device)
        for dp in (-1, 0, 1):
            for dr in (-1, 0, 1):
                ok = (p + dp >= 0) & (p + dp < np_) & (r + dr >= 0) & (r + dr < nr)
                e = ((dz + 1) * 3 + (dp + 1)) * 3 + (dr + 1)
                M[:, rows[ok], rows[ok] + dp * nr + dr] = flat[:, ok, e]
        blocks.append(M)
    return tuple(blocks)


def pole_basis(np_: int, nr: int, dtype, device) -> torch.Tensor:
    """Q (NP*NR, 1 + NP*(NR-1)): column 0 is the tied axis node (1 at every
    azimuth copy), the others one off-axis node each."""
    n = np_ * nr
    Q = torch.zeros((n, 1 + np_ * (nr - 1)), dtype=dtype, device=device)
    axis = torch.arange(np_, device=device) * nr
    Q[axis, 0] = 1.0
    off = torch.tensor([k for k in range(n) if k % nr != 0], device=device)
    Q[off, 1 + torch.arange(off.numel(), device=device)] = 1.0
    return Q


def block_thomas(blocks, rhs, precision: str) -> torch.Tensor:
    """Solve the block-tridiagonal system. ``blocks(i)`` returns plane i's
    (lower, diagonal, upper) blocks (B, n, n); rhs (B, N, n, S). Returns x
    (B, N, n, S)."""
    N = rhs.shape[1]
    upper_solved, d_solved = [], []
    for i in range(N):
        lower, diag, upper = blocks(i)
        d = rhs[:, i]
        if i:
            diag = diag - matmul(lower, upper_solved[-1], precision)
            d = d - matmul(lower, d_solved[-1], precision)
        n = diag.shape[-1]
        X = torch.linalg.solve(diag, torch.cat([upper, d], dim=-1))
        upper_solved.append(X[..., :n])
        d_solved.append(X[..., n:])
    x = [None] * N
    x[-1] = d_solved[-1]
    for i in range(N - 2, -1, -1):
        x[i] = d_solved[i] - matmul(upper_solved[i], x[i + 1], precision)
    return torch.stack(x, dim=1)


def solve_2d(C: torch.Tensor, rhs: torch.Tensor, precision: str) -> torch.Tensor:
    """w with A w = rhs: C (B, NZ, NR, 3, 3), rhs (B, S, NZ, NR)."""
    lower, diag, upper = tridiag_blocks_2d(C)
    x = block_thomas(lambda i: (lower[:, i], diag[:, i], upper[:, i]),
                     rhs.permute(0, 2, 3, 1), precision)
    return x.permute(0, 3, 1, 2)


def solve_3d_pole_tied(C: torch.Tensor, rhs: torch.Tensor, precision: str) -> torch.Tensor:
    """The axis values y_axis (B, S, NZ) of the pole-tied solve: w = Q y with
    Q^T A Q y = Q^T rhs; C (B, NZ, NP, NR, 27), rhs (B, S, NZ, NP, NR)."""
    B, S, nz, np_, nr = rhs.shape
    Q = pole_basis(np_, nr, C.dtype, C.device)

    def blocks(i):
        return tuple(matmul(matmul(Q.T, M, precision), Q, precision)
                     for M in plane_blocks_3d(C[:, i], np_, nr))

    b = rhs.permute(0, 2, 3, 4, 1).reshape(B, nz, np_ * nr, S)
    y = block_thomas(blocks, matmul(Q.T, b, precision), precision)
    return y[:, :, 0, :].permute(0, 2, 1)
