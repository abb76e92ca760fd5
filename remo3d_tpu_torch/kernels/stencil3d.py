# -*- coding: utf-8 -*-
"""Symmetric half-storage 27-point stencil apply: the CUDA kernel, its plain
torch version and the dispatching wrapper.

Port of ``remo3d_tpu.ops.pallas_stencil`` (``stencil3d_apply_pallas``). The
assembled FEM stencil is symmetric (``C[n, d] == C[n+d, -d]``), so only the
diagonal and the 13 lexicographically positive offset planes are stored, and
each offset plane serves two couplings:

    y(n) = C0(n) u(n) + sum_d [ C_d(n) u(n+d) + C_d(n-d) u(n-d) ]

with zero fill at every grid edge. The kernel (``csrc/stencil3d.cu``) gives a
block a slab of whole (NP, NR) planes, stages the u of all S solves of that
slab in shared memory and keeps a node's 27 coefficients in registers across
the S solves. The JAX kernel's lane padding and three-call split size TPU VMEM
and have no counterpart here.

With ``pole=True`` both the kernel and the plain version compute
``pole_project(A pole_project(u))``: the pole tie that wraps the operator in
the pole-tied CG, done by the kernel on the slab it already holds. The kernel
sums the NP azimuth copies sequentially, ``torch.mean`` in its own order: the
two agree to 1e-6 of max|y| in float32 and 1e-13 in float64.

:func:`stencil3d_apply_half` sends a tensor that lies on the CPU to
:func:`stencil3d_apply_half_plain`; any other tensor launches the kernel or
raises. There is no fallback from a failed build or launch.

Every call goes through :class:`StencilApplyHalf3D`, so a kernel result carries
its gradient: the operator, and with ``pole`` also ``P A P`` (the projector is
orthogonal), is symmetric, so ``grad_u`` is the same kernel on the output's
cotangent, and ``grad_C_half`` is the coefficient contraction
:func:`stencil_half_coeff_grad_3d` (plain torch, as XLA differentiates the JAX
package's apply), taken on ``P g`` and ``P u`` with ``pole``.
"""

from __future__ import annotations

import sys

import torch

from ..ops.stencil3d import entry_index, pole_project
from . import COUNTED, build
from .stencil2d import _window

# Diagonal + 13 positive offsets (lexicographic order over (dz, dp, dr)).
POS_OFFSETS = [
    (dz, dp, dr)
    for dz in (-1, 0, 1)
    for dp in (-1, 0, 1)
    for dr in (-1, 0, 1)
    if (dz, dp, dr) > (0, 0, 0)
]
HALF_ENTRIES = [entry_index(0, 0, 0)] + [entry_index(*d) for d in POS_OFFSETS]

# Kernel launches since import (or since a caller reset it): one per launch.
# A launch recorded into a CUDA graph being captured counts in CAPTURED
# instead; it runs at every replay of the graph, and the replay adds it to
# LAUNCHES (ops/cg.py, through the package's COUNTED).
LAUNCHES = 0
CAPTURED = 0
COUNTED.append(sys.modules[__name__])

_ENTRY = {torch.float32: "stencil3d_half_f32", torch.float64: "stencil3d_half_f64"}
_INFO_ENTRY = {torch.float32: "stencil3d_half_info_f32", torch.float64: "stencil3d_half_info_f64"}


def half_planes_3d(C: torch.Tensor) -> torch.Tensor:
    """(..., NZ, NP, NR, 27) stencil -> (..., 14, NZ, NP, NR) contiguous half storage."""
    return torch.stack([C[..., e] for e in HALF_ENTRIES], dim=-4).contiguous()


def stencil3d_apply_half_plain(
    C_half: torch.Tensor, u: torch.Tensor, pole: bool = False
) -> torch.Tensor:
    """y = A u (or P A P u with ``pole``) from half storage, in plain torch
    (shifted slices).

    C_half: (B, 14, NZ, NP, NR); u: (B, S, NZ, NP, NR). The per-element order of
    the sums is the kernel's: diagonal, then for each offset the direct and the
    mirrored coupling.
    """
    if pole:
        return pole_project(stencil3d_apply_half_plain(C_half, pole_project(u)))
    nz, np_, nr = u.shape[-3], u.shape[-2], u.shape[-1]
    y = C_half[:, 0:1] * u
    for k, (dz, dp, dr) in enumerate(POS_OFFSETS):
        c = C_half[:, k + 1 : k + 2]  # (B, 1, NZ, NP, NR), broadcast over S
        (zd, zs), (pd, ps), (rd, rs) = _window(dz, nz), _window(dp, np_), _window(dr, nr)
        # Direct coupling at n: C_d(n) u(n+d).
        y[..., zd, pd, rd] += c[..., zd, pd, rd] * u[..., zs, ps, rs]
        # Mirrored coupling at n+d: C_d(n) u(n).
        y[..., zs, ps, rs] += c[..., zd, pd, rd] * u[..., zd, pd, rd]
    return y


def _check(C_half: torch.Tensor, u: torch.Tensor) -> None:
    if u.ndim != 5 or C_half.ndim != 5:
        raise ValueError(
            f"expected C_half (B, 14, NZ, NP, NR) and u (B, S, NZ, NP, NR), got "
            f"{tuple(C_half.shape)} and {tuple(u.shape)}"
        )
    B, S, nz, np_, nr = u.shape
    if tuple(C_half.shape) != (B, 14, nz, np_, nr):
        raise ValueError(f"C_half {tuple(C_half.shape)} does not match u {tuple(u.shape)}")
    if u.dtype not in _ENTRY or C_half.dtype != u.dtype:
        raise ValueError(f"dtypes {C_half.dtype}/{u.dtype}: need float32 or float64, equal")
    if not (C_half.is_contiguous() and u.is_contiguous()):
        raise ValueError("C_half and u must be contiguous")
    n = nz * np_ * nr
    if B * max(S, 14) * n >= 2**31 or B > 65535:
        raise ValueError(f"u {tuple(u.shape)} exceeds the kernel's int32 indexing")


def kernel_info(
    S: int, np_: int, nr: int, dtype: torch.dtype = torch.float32, tile_rows: int = 0
) -> dict:
    """Registers, spill bytes, shared memory, tile height, solves per group and
    resident blocks per SM of a launch with S solves on (np_, nr) planes."""
    return build.kernel_info(_INFO_ENTRY[dtype], S, np_, nr, tile_rows)


def _apply(C_half: torch.Tensor, u: torch.Tensor, pole: bool, tile_rows: int) -> torch.Tensor:
    """The plain version for CPU tensors, else one kernel launch (no autograd)."""
    global LAUNCHES, CAPTURED
    if u.device.type == "cpu" and C_half.device.type == "cpu":
        return stencil3d_apply_half_plain(C_half, u, pole)
    _check(C_half, u)
    lib = build.load_library()
    if u.device.type != "cuda" or C_half.device != u.device:
        raise ValueError(f"the kernel needs CUDA tensors on one device, got {u.device}")
    y = torch.empty_like(u)
    B, S, nz, np_, nr = u.shape
    with torch.cuda.device(u.device):
        capturing = torch.cuda.is_current_stream_capturing()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[u.dtype])(
            C_half.data_ptr(), u.data_ptr(), y.data_ptr(), B, S, nz, np_, nr, int(pole),
            tile_rows, stream,
        )
    if err != 0:
        raise RuntimeError(f"stencil3d_half launch failed: CUDA error {err}")
    if capturing:
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return y


def stencil_half_coeff_grad_3d(g: torch.Tensor, u: torch.Tensor, pole: bool = False) -> torch.Tensor:
    """d<g, A u>/dC_half (with ``pole``: d<g, P A P u>/dC_half), summed over the
    solve axis: (B, 14, NZ, NP, NR).

    Diagonal plane: sum_s g(n) u(n); offset d: sum_s [g(n) u(n+d) + g(n+d) u(n)]
    where n and n+d lie on the grid, zero elsewhere; with ``pole`` on P g and P u.
    """
    if pole:
        g, u = pole_project(g), pole_project(u)
    nz, np_, nr = u.shape[-3], u.shape[-2], u.shape[-1]
    out = u.new_zeros((u.shape[0], 14, nz, np_, nr))
    out[:, 0] = (g * u).sum(1)
    for k, (dz, dp, dr) in enumerate(POS_OFFSETS):
        (zd, zs), (pd, ps), (rd, rs) = _window(dz, nz), _window(dp, np_), _window(dr, nr)
        out[:, k + 1, zd, pd, rd] = (
            g[..., zd, pd, rd] * u[..., zs, ps, rs] + g[..., zs, ps, rs] * u[..., zd, pd, rd]
        ).sum(1)
    return out


class StencilApplyHalf3D(torch.autograd.Function):
    """y = A u or P A P u (:func:`_apply`: K2 or, on the CPU, its plain version)
    with both derivatives: reverse (``grad_u`` = K2 on the cotangent, the
    operator being symmetric; ``grad_C_half`` by
    :func:`stencil_half_coeff_grad_3d`) and forward (``dy = K(dC_half, u) +
    K(C_half, du)``, two launches)."""

    @staticmethod
    def forward(C_half, u, pole, tile_rows):
        return _apply(C_half, u, pole, tile_rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        C_half, u, pole, _ = inputs
        ctx.pole = pole
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(C_half, u)
        ctx.save_for_forward(C_half, u)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None, None
        C_half, u = ctx.saved_tensors
        g = g.contiguous()
        grad_C = grad_u = None
        if ctx.needs_input_grad[0]:
            grad_C = stencil_half_coeff_grad_3d(g, u, ctx.pole)
        if ctx.needs_input_grad[1]:
            grad_u = StencilApplyHalf3D.apply(C_half, g, ctx.pole, 0)
        return grad_C, grad_u, None, None

    @staticmethod
    def jvp(ctx, dC_half, du, _pole, _tile_rows):
        C_half, u = ctx.saved_tensors
        dy = None
        if dC_half is not None:
            dy = _apply(dC_half.contiguous(), u, ctx.pole, 0)
        if du is not None:
            y_u = _apply(C_half, du.contiguous(), ctx.pole, 0)
            dy = y_u if dy is None else dy + y_u
        return dy if dy is not None else torch.zeros_like(u)


def stencil3d_apply_half(
    C_half: torch.Tensor, u: torch.Tensor, pole: bool = False, tile_rows: int = 0
) -> torch.Tensor:
    """y = A u from half storage: plain torch for CPU tensors, else the kernel;
    differentiable in both arguments (:class:`StencilApplyHalf3D`).

    C_half: (B, 14, NZ, NP, NR) from :func:`half_planes_3d`; u: (B, S, NZ, NP, NR).
    With ``pole`` the result is ``pole_project(A pole_project(u))``; u itself is
    not modified. ``tile_rows`` forces the kernel's planes per block (a tuning
    sweep's knob; 0 is the kernel's own choice and what every caller uses).
    """
    return StencilApplyHalf3D.apply(C_half, u, pole, tile_rows)
