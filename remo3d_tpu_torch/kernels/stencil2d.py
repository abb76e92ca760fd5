# -*- coding: utf-8 -*-
"""Symmetric half-storage 9-point stencil apply: the CUDA kernel, its plain
torch version and the dispatching wrapper.

Port of ``remo3d_tpu.ops.pallas_stencil2d`` (``stencil_apply_pallas_2d``). The
assembled FEM stencil is symmetric (``C[n, d] == C[n+d, -d]``), so only the
diagonal and the 4 lexicographically positive offset planes are stored, and each
offset plane serves two couplings:

    y(n) = C0(n) u(n) + sum_d [ C_d(n) u(n+d) + C_d(n-d) u(n-d) ]

with zero fill at every grid edge. The kernel (``csrc/stencil2d.cu``) gives a
block a tile of whole rows, stages the u of all S solves of that tile in shared
memory and keeps a node's 9 coefficients in registers across the S solves.

:func:`stencil_apply_half_2d` sends a tensor that lies on the CPU to
:func:`stencil_apply_half_2d_plain`; any other tensor launches the kernel or
raises. There is no fallback from a failed build or launch.
"""

from __future__ import annotations

import torch

from . import build

# Positive offsets (dz, dr), lexicographic; (di, dj) = (dz+1, dr+1) in C[..., 3, 3].
POS_OFFSETS_2D = [(0, 1), (1, -1), (1, 0), (1, 1)]

# Kernel launches since import (or since a caller reset it): one per launch.
LAUNCHES = 0

_ENTRY = {torch.float32: "stencil2d_half_f32", torch.float64: "stencil2d_half_f64"}
_INFO_ENTRY = {torch.float32: "stencil2d_half_info_f32", torch.float64: "stencil2d_half_info_f64"}


def half_planes_2d(C: torch.Tensor) -> torch.Tensor:
    """(..., NZ, NR, 3, 3) stencil -> (..., 5, NZ, NR) contiguous half storage."""
    planes = [C[..., 1, 1]] + [C[..., dz + 1, dr + 1] for dz, dr in POS_OFFSETS_2D]
    return torch.stack(planes, dim=-3).contiguous()


def _window(d: int, n: int):
    """(destination n, source n+d) slices along one axis where both lie inside."""
    return slice(max(0, -d), n - max(0, d)), slice(max(0, d), n - max(0, -d))


def stencil_apply_half_2d_plain(C_half: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y = A u from half storage, in plain torch (shifted slices).

    C_half: (B, 5, NZ, NR); u: (B, S, NZ, NR). The per-element order of the sums
    is the kernel's: diagonal, then for each offset the direct and the mirrored
    coupling.
    """
    nz, nr = u.shape[-2], u.shape[-1]
    y = C_half[:, 0:1] * u
    for k, (dz, dr) in enumerate(POS_OFFSETS_2D):
        c = C_half[:, k + 1 : k + 2]  # (B, 1, NZ, NR), broadcast over S
        (zd, zs), (rd, rs) = _window(dz, nz), _window(dr, nr)
        # Direct coupling at n: C_d(n) u(n+d).
        y[..., zd, rd] += c[..., zd, rd] * u[..., zs, rs]
        # Mirrored coupling at n+d: C_d(n) u(n).
        y[..., zs, rs] += c[..., zd, rd] * u[..., zd, rd]
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


def stencil_apply_half_2d(
    C_half: torch.Tensor, u: torch.Tensor, tile_rows: int = 0
) -> torch.Tensor:
    """y = A u from half storage: plain torch for CPU tensors, else the kernel.

    C_half: (B, 5, NZ, NR) from :func:`half_planes_2d`; u: (B, S, NZ, NR).
    ``tile_rows`` forces the kernel's rows per block (a tuning sweep's knob; 0
    is the kernel's own choice and what every caller uses).
    """
    global LAUNCHES
    if u.device.type == "cpu" and C_half.device.type == "cpu":
        return stencil_apply_half_2d_plain(C_half, u)
    _check(C_half, u)
    lib = build.load_library()
    if u.device.type != "cuda" or C_half.device != u.device:
        raise ValueError(f"the kernel needs CUDA tensors on one device, got {u.device}")
    y = torch.empty_like(u)
    B, S, nz, nr = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[u.dtype])(
            C_half.data_ptr(), u.data_ptr(), y.data_ptr(), B, S, nz, nr, tile_rows, stream
        )
    if err != 0:
        raise RuntimeError(f"stencil2d_half launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y
