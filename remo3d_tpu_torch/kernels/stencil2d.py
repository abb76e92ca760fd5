# -*- coding: utf-8 -*-
"""Symmetric half-storage 9-point stencil apply: the CUDA kernel, its plain
torch version and the dispatching wrapper.

Port of ``remo3d_tpu.ops.pallas_stencil2d`` (``stencil_apply_pallas_2d``). The
assembled FEM stencil is symmetric (``C[n, d] == C[n+d, -d]``), so only the 4
lexicographically positive offset planes are stored, each serving two
couplings, beside the row sum R(n) of the operator. The apply is in
difference form:

    y(n) = R(n) u(n) + sum_d [ C_d(n) (u(n+d) - u(n)) + C_d(n-d) (u(n-d) - u(n)) ]

with every coupling present only where its neighbour lies inside the grid.
In exact arithmetic it is the diagonal form ``C0(n) u(n) + sum_d [...]``. In
float32 it is not: the FEM operator annihilates constants (R = 0 away from
the Dirichlet nodes), and the axis potentials u are large and smooth, so the
diagonal form cancels ~1e4 times the result in every row and rounds at
``eps |C0| |u|``, while the difference form rounds at ``eps |C_d| |u(n+d) -
u(n)|``. That rounding is what limits a float32 CG solve: on the 761x161
grid the float32 readouts sit about 10x closer to the float64 ones through
this form (PERF.md, C2; ``tests/test_torch_spread.py --chunk``). The kernel
(``csrc/stencil2d.cu``) gives a block a tile of whole rows, stages the u of
all S solves of that tile in shared memory and keeps a node's 9 coefficients
in registers across the S solves.

:func:`stencil_apply_half_2d` sends a tensor that lies on the CPU to
:func:`stencil_apply_half_2d_plain`; any other tensor launches the kernel or
raises. There is no fallback from a failed build or launch.

Every call goes through :class:`StencilApplyHalf2D`, so a kernel result carries
its gradient: the operator is symmetric, so ``grad_u`` is the same kernel on the
output's cotangent, and ``grad_C_half`` is the coefficient contraction
:func:`stencil_half_coeff_grad_2d` (plain torch, as XLA differentiates the
JAX package's apply).
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from . import COUNTED, build

# Positive offsets (dz, dr), lexicographic; (di, dj) = (dz+1, dr+1) in C[..., 3, 3].
POS_OFFSETS_2D = [(0, 1), (1, -1), (1, 0), (1, 1)]

# Kernel launches since import (or since a caller reset it): one per launch.
# A launch recorded into a CUDA graph being captured counts in CAPTURED
# instead; it runs at every replay of the graph, and the replay adds it to
# LAUNCHES (ops/cg.py, through the package's COUNTED).
LAUNCHES = 0
CAPTURED = 0
COUNTED.append(sys.modules[__name__])

_ENTRY = {torch.float32: "stencil2d_half_f32", torch.float64: "stencil2d_half_f64"}
_INFO_ENTRY = {torch.float32: "stencil2d_half_info_f32", torch.float64: "stencil2d_half_info_f64"}


def half_planes_2d(C: torch.Tensor) -> torch.Tensor:
    """(..., NZ, NR, 3, 3) stencil -> (..., 5, NZ, NR) contiguous half storage:
    the row sum R, then the 4 positive offset planes (the JAX package's half
    storage holds the diagonal where this holds R). R is summed in float64 in
    a fixed order (the diagonal, then each offset's direct and mirrored
    coupling where its neighbour lies inside the grid) and rounded once, so
    every device computes the same R."""
    nz, nr = C.shape[-4], C.shape[-3]
    planes = [C[..., dz + 1, dr + 1] for dz, dr in POS_OFFSETS_2D]
    row_sum = C[..., 1, 1].double()
    for c, (dz, dr) in zip(planes, POS_OFFSETS_2D):
        (zd, zs), (rd, rs) = _window(dz, nz), _window(dr, nr)
        inside = c[..., zd, rd].double()
        for z, r in ((zd, rd), (zs, rs)):  # C_d(n) at n, then mirrored at n+d
            row_sum = row_sum + F.pad(inside, (r.start, nr - r.stop, z.start, nz - z.stop))
    return torch.stack([row_sum.to(C.dtype)] + planes, dim=-3).contiguous()


def _window(d: int, n: int):
    """(destination n, source n+d) slices along one axis where both lie inside."""
    return slice(max(0, -d), n - max(0, d)), slice(max(0, d), n - max(0, -d))


def stencil_apply_half_2d_plain(C_half: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y = A u from half storage in difference form, in plain torch (shifted
    slices).

    C_half: (B, 5, NZ, NR) from :func:`half_planes_2d`; u: (B, S, NZ, NR). The
    per-element order of the sums is the kernel's: R u(n), then for each
    offset the direct and the mirrored coupling.
    """
    nz, nr = u.shape[-2], u.shape[-1]
    y = C_half[:, 0:1] * u
    for k, (dz, dr) in enumerate(POS_OFFSETS_2D):
        c = C_half[:, k + 1 : k + 2]  # (B, 1, NZ, NR), broadcast over S
        (zd, zs), (rd, rs) = _window(dz, nz), _window(dr, nr)
        du = u[..., zs, rs] - u[..., zd, rd]  # u(n+d) - u(n)
        # Direct coupling at n: C_d(n) (u(n+d) - u(n)).
        y[..., zd, rd] += c[..., zd, rd] * du
        # Mirrored coupling at n+d: C_d(n) (u(n) - u(n+d)).
        y[..., zs, rs] -= c[..., zd, rd] * du
    return y


def _check(C_half: torch.Tensor, u: torch.Tensor) -> None:
    if u.ndim != 4 or C_half.ndim != 4:
        raise ValueError(
            f"expected C_half (B, 5, NZ, NR) and u (B, S, NZ, NR), got "
            f"{tuple(C_half.shape)} and {tuple(u.shape)}"
        )
    B, _, nz, nr = u.shape
    if tuple(C_half.shape) != (B, 5, nz, nr):
        raise ValueError(f"C_half {tuple(C_half.shape)} does not match u {tuple(u.shape)}")
    if u.dtype not in _ENTRY or C_half.dtype != u.dtype:
        raise ValueError(f"dtypes {C_half.dtype}/{u.dtype}: need float32 or float64, equal")
    if not (C_half.is_contiguous() and u.is_contiguous()):
        raise ValueError("C_half and u must be contiguous")
    if max(u.shape) >= 2**31:
        raise ValueError(f"extent of u {tuple(u.shape)} exceeds the kernel's int sizes")


def kernel_info(
    S: int, nr: int, dtype: torch.dtype = torch.float32, tile_rows: int = 0
) -> dict:
    """Registers, spill bytes, shared memory, tile height, solves per group and
    resident blocks per SM of a launch with S solves on rows of nr nodes."""
    return build.kernel_info(_INFO_ENTRY[dtype], S, nr, tile_rows)


def _apply(C_half: torch.Tensor, u: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """The plain version for CPU tensors, else one kernel launch (no autograd)."""
    global LAUNCHES, CAPTURED
    if u.device.type == "cpu" and C_half.device.type == "cpu":
        return stencil_apply_half_2d_plain(C_half, u)
    _check(C_half, u)
    lib = build.load_library()
    if u.device.type != "cuda" or C_half.device != u.device:
        raise ValueError(f"the kernel needs CUDA tensors on one device, got {u.device}")
    y = torch.empty_like(u)
    B, S, nz, nr = u.shape
    with torch.cuda.device(u.device):
        capturing = torch.cuda.is_current_stream_capturing()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[u.dtype])(
            C_half.data_ptr(), u.data_ptr(), y.data_ptr(), B, S, nz, nr, tile_rows, stream
        )
    if err != 0:
        raise RuntimeError(f"stencil2d_half launch failed: CUDA error {err}")
    if capturing:
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return y


def stencil_half_coeff_grad_2d(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """d<g, A u>/dC_half, summed over the solve axis: (B, 5, NZ, NR).

    Row-sum plane: sum_s g(n) u(n); offset d: sum_s (g(n) - g(n+d)) (u(n+d) -
    u(n)) where n and n+d lie on the grid, zero elsewhere (the apply never
    reads those coefficients).
    """
    nz, nr = u.shape[-2], u.shape[-1]
    out = u.new_zeros((u.shape[0], 5, nz, nr))
    out[:, 0] = (g * u).sum(1)
    for k, (dz, dr) in enumerate(POS_OFFSETS_2D):
        (zd, zs), (rd, rs) = _window(dz, nz), _window(dr, nr)
        out[:, k + 1, zd, rd] = (
            (g[..., zd, rd] - g[..., zs, rs]) * (u[..., zs, rs] - u[..., zd, rd])
        ).sum(1)
    return out


class StencilApplyHalf2D(torch.autograd.Function):
    """y = A u (:func:`_apply`: K1 or, on the CPU, its plain version) with both
    derivatives: reverse (``grad_u`` = K1 on the cotangent, A being symmetric;
    ``grad_C_half`` by :func:`stencil_half_coeff_grad_2d`) and forward
    (``dy = A(dC_half) u + A(C_half) du``, two launches)."""

    @staticmethod
    def forward(C_half, u, tile_rows):
        return _apply(C_half, u, tile_rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        C_half, u, _ = inputs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(C_half, u)
        ctx.save_for_forward(C_half, u)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        C_half, u = ctx.saved_tensors
        g = g.contiguous()
        grad_C = stencil_half_coeff_grad_2d(g, u) if ctx.needs_input_grad[0] else None
        grad_u = StencilApplyHalf2D.apply(C_half, g, 0) if ctx.needs_input_grad[1] else None
        return grad_C, grad_u, None

    @staticmethod
    def jvp(ctx, dC_half, du, _):
        C_half, u = ctx.saved_tensors
        dy = None
        if dC_half is not None:
            dy = _apply(dC_half.contiguous(), u, 0)
        if du is not None:
            y_u = _apply(C_half, du.contiguous(), 0)
            dy = y_u if dy is None else dy + y_u
        return dy if dy is not None else torch.zeros_like(u)


def stencil_apply_half_2d(
    C_half: torch.Tensor, u: torch.Tensor, tile_rows: int = 0
) -> torch.Tensor:
    """y = A u from half storage: plain torch for CPU tensors, else the kernel;
    differentiable in both arguments (:class:`StencilApplyHalf2D`).

    C_half: (B, 5, NZ, NR) from :func:`half_planes_2d`; u: (B, S, NZ, NR).
    ``tile_rows`` forces the kernel's rows per block (a tuning sweep's knob; 0
    is the kernel's own choice and what every caller uses).
    """
    return StencilApplyHalf2D.apply(C_half, u, tile_rows)
