# -*- coding: utf-8 -*-
"""Line (tridiagonal) relaxation for the 27-point 3D stencil.

Counterpart of ``remo3d_tpu.ops.lines3d``: parallel-cyclic-reduction solves
(see :mod:`.lines`) along each of the three grid directions. The
sheared-cylindrical grids carry anisotropy in all three orientations (thin
radial stations, tiny azimuthal arcs near the axis, fine source z-bands), which
the 3D CG preconditioner's line sweep handles direction by direction.
"""

from __future__ import annotations

from .lines import pcr_apply, pcr_factor, pcr_solve
from .stencil3d import entry_index

_LINE_AXES = {  # direction -> (lower offset, upper offset, grid axis)
    "z": ((-1, 0, 0), (1, 0, 0), -3),
    "p": ((0, -1, 0), (0, 1, 0), -2),
    "r": ((0, 0, -1), (0, 0, 1), -1),
}


def _solve(C, b, direction, max_steps=None):
    lo, hi, axis = _LINE_AXES[direction]
    Cb = C if b.ndim == C.ndim - 1 else C.unsqueeze(-5)
    dl, d, du = (
        Cb[..., entry_index(*off)].expand(b.shape) for off in (lo, (0, 0, 0), hi)
    )
    return pcr_solve(dl, d, du, b, axis=axis, max_steps=max_steps)


def line_solve_r3(C, b, max_steps=None):
    """Radial lines: couplings (0,0,-1), diag, (0,0,+1) along the last axis."""
    return _solve(C, b, "r", max_steps)


def line_solve_p3(C, b, max_steps=None):
    """Azimuthal lines: couplings (0,-1,0), diag, (0,+1,0) along axis -2."""
    return _solve(C, b, "p", max_steps)


def line_solve_z3(C, b, max_steps=None):
    """Axial lines: couplings (-1,0,0), diag, (+1,0,0) along axis -3."""
    return _solve(C, b, "z", max_steps)


def line_factor3(C, direction: str, max_steps=None):
    """Factorize the tridiagonal line part of the 27-pt stencil along a direction.

    Computed once per assembled operator (C's batch + grid shape) and applied
    to any number of right-hand sides via :func:`line_apply3`, the hot path of
    the 3D CG preconditioner.
    """
    lo, hi, axis = _LINE_AXES[direction]
    steps, dinv = pcr_factor(
        C[..., entry_index(*lo)],
        C[..., entry_index(0, 0, 0)],
        C[..., entry_index(*hi)],
        axis=axis,
        max_steps=max_steps,
    )
    return steps, dinv, axis


def line_apply3(factors, b):
    """Apply a :func:`line_factor3` factorization to b (extra solve axis OK)."""
    steps, dinv, axis = factors
    if b.ndim - dinv.ndim:
        steps = [(al.unsqueeze(-4), be.unsqueeze(-4)) for al, be in steps]
        dinv = dinv.unsqueeze(-4)
    return pcr_apply(steps, dinv, b, axis=axis)
