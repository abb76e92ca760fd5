# -*- coding: utf-8 -*-
"""Symmetric half-storage 27-point stencil apply: the CUDA kernel, its plain
torch version and the dispatching wrapper.

Port of ``remo3d_tpu.ops.pallas_stencil`` (``stencil3d_apply_pallas``). The
assembled FEM stencil is symmetric (``C[n, d] == C[n+d, -d]``), so only the
diagonal and the 13 lexicographically positive offset planes are stored, and
each offset plane serves two couplings:

    y(n) = C0(n) u(n) + sum_d [ C_d(n) u(n+d) + C_d(n-d) u(n-d) ]

with zero fill at every grid edge. The kernel (``csrc/stencil3d.cu``) reads a
batch's 14 planes once for all of its S solves. The JAX kernel's z-slab
staging, lane padding and three-call split size TPU VMEM and have no
counterpart here.

:func:`stencil3d_apply_half` sends a tensor that lies on the CPU to
:func:`stencil3d_apply_half_plain`; any other tensor launches the kernel or
raises. There is no fallback from a failed build or launch.
"""

from __future__ import annotations

import torch

from ..ops.stencil3d import entry_index
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


def half_planes_3d(C: torch.Tensor) -> torch.Tensor:
    """(..., NZ, NP, NR, 27) stencil -> (..., 14, NZ, NP, NR) contiguous half storage."""
    return torch.stack([C[..., e] for e in HALF_ENTRIES], dim=-4).contiguous()


def stencil3d_apply_half_plain(C_half: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y = A u from half storage, in plain torch (shifted slices).

    C_half: (B, 14, NZ, NP, NR); u: (B, S, NZ, NP, NR). The per-element order of
    the sums is the kernel's: diagonal, then for each offset the direct and the
    mirrored coupling.
    """
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


def stencil3d_apply_half(C_half: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y = A u from half storage: plain torch for CPU tensors, else the kernel.

    C_half: (B, 14, NZ, NP, NR) from :func:`half_planes_3d`; u: (B, S, NZ, NP, NR).
    """
    global LAUNCHES
    if u.device.type == "cpu" and C_half.device.type == "cpu":
        return stencil3d_apply_half_plain(C_half, u)
    _check(C_half, u)
    lib = build.load_library()
    if u.device.type != "cuda" or C_half.device != u.device:
        raise ValueError(f"the kernel needs CUDA tensors on one device, got {u.device}")
    y = torch.empty_like(u)
    B, S, nz, np_, nr = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[u.dtype])(
            C_half.data_ptr(), u.data_ptr(), y.data_ptr(), B, S, nz, np_, nr, stream
        )
    if err != 0:
        raise RuntimeError(f"stencil3d_half launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y
