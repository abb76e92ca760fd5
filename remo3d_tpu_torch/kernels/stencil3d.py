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
"""

from __future__ import annotations

import torch

from ..ops.stencil3d import entry_index, pole_project
from . import build
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
LAUNCHES = 0

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


def stencil3d_apply_half(
    C_half: torch.Tensor, u: torch.Tensor, pole: bool = False, tile_rows: int = 0
) -> torch.Tensor:
    """y = A u from half storage: plain torch for CPU tensors, else the kernel.

    C_half: (B, 14, NZ, NP, NR) from :func:`half_planes_3d`; u: (B, S, NZ, NP, NR).
    With ``pole`` the result is ``pole_project(A pole_project(u))``; u itself is
    not modified. ``tile_rows`` forces the kernel's planes per block (a tuning
    sweep's knob; 0 is the kernel's own choice and what every caller uses).
    """
    global LAUNCHES
    if u.device.type == "cpu" and C_half.device.type == "cpu":
        return stencil3d_apply_half_plain(C_half, u, pole)
    _check(C_half, u)
    lib = build.load_library()
    if u.device.type != "cuda" or C_half.device != u.device:
        raise ValueError(f"the kernel needs CUDA tensors on one device, got {u.device}")
    y = torch.empty_like(u)
    B, S, nz, np_, nr = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[u.dtype])(
            C_half.data_ptr(), u.data_ptr(), y.data_ptr(), B, S, nz, np_, nr, int(pole),
            tile_rows, stream,
        )
    if err != 0:
        raise RuntimeError(f"stencil3d_half launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y
