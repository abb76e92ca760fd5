# -*- coding: utf-8 -*-
"""Factored PCR tridiagonal line apply (kernel K3): the dispatching wrapper of
the CUDA kernel, whose plain version is ``ops.lines.pcr_apply``.

Port of the JAX package's Pallas line kernels ``pcr_apply_pallas`` /
``line_rz_apply_pallas`` (``remo3d_tpu/ops/pallas_lines2d.py:116``) and
``line_apply3_pallas`` (``remo3d_tpu/ops/pallas_lines3d.py:74``), both at
commit 9fd23cb^. They were removed there because, inside a ``lax`` loop, they
hung the TPU; what they computed, the JAX package computes today with its
plain ``remo3d_tpu/ops/lines.py:111`` ``pcr_apply``. This is that function:
for each reduction level k (shift s = 2^k)

    x <- x + alpha_k x[i - s] + beta_k x[i + s]      (zero outside the line)

then ``x * dinv``, along one axis of the grid, for every line of every solve.

Bound: device-memory bytes. The least traffic of one apply is b read and x
written once per solve plus the coefficients that the function reads, once
per batch: on a line of n nodes, level k (s = 2^k < n) reads alpha_k only at
i >= s and beta_k only at i < n - s, then dinv everywhere,
:func:`coefficient_values`; four flops per level, node and solve do not come
near the compute rate. The plain version moves
the solution array about ten times per level (a copy, two windowed
multiply-adds). The kernel (``csrc/pcr_lines.cu``) gives a block a tile of
whole lines of one batch, holds all S solves of the tile in shared memory
through every level, reads each coefficient once per tile and level and
applies it to the S solves, and writes x once: the per-level intermediate
never reaches device memory. A line of all S solves must fit in a block's
shared memory, twice; a longer one is refused. The coefficients keep the solve's dtype (the
Pallas kernels stored them in bfloat16), and every product and sum is rounded
on its own in the plain version's order.

:func:`pcr_apply_lines` sends tensors that lie on the CPU to the plain
version; any other tensor launches the kernel or raises. There is no fallback
from a failed build or launch. It records no autograd graph: its callers (the
multigrid smoother and the 3D ADI sweep) run inside ``ops.cg.pcg``'s
``torch.no_grad``, or build the preconditioner from a detached operator.
"""

from __future__ import annotations

import sys

import torch

from ..ops import lines as _lines
from . import COUNTED, build

# Kernel launches since import (or since a caller reset it): one per launch.
# A launch recorded into a CUDA graph being captured counts in CAPTURED
# instead; it runs at every replay of the graph, and the replay adds it to
# LAUNCHES (ops/cg.py, through the package's COUNTED).
LAUNCHES = 0
CAPTURED = 0
COUNTED.append(sys.modules[__name__])

# A block's shared memory on sm_90 (slab::kMaxSmemBytes in csrc/slab_stage.cuh).
MAX_SMEM_BYTES = 232448

_ENTRY = {torch.float32: "pcr_lines_f32", torch.float64: "pcr_lines_f64"}
_INFO_ENTRY = {torch.float32: "pcr_lines_info_f32", torch.float64: "pcr_lines_info_f64"}


def line_view(shape, axis: int) -> tuple[int, int, int]:
    """(outer, n, inner) of a grid ``shape`` with its lines along ``axis``
    (negative): the product of the axes before it, its length, and the
    product of the axes after it (the stride of a line)."""
    k = len(shape) + axis
    outer = inner = 1
    for e in shape[:k]:
        outer *= e
    for e in shape[k + 1 :]:
        inner *= e
    return outer, shape[k], inner


def coefficient_values(n: int, L: int) -> int:
    """Coefficients that an apply of L levels reads on one line of n nodes:
    alpha_k at i >= s and beta_k at i < n - s for each level with s = 2^k <
    n (a level with s >= n changes nothing), then dinv at every node."""
    return n + sum(2 * (n - 2**k) for k in range(L) if 2**k < n)


def least_work(B: int, S: int, grid, axis: int, L: int, itemsize: int) -> tuple[int, int]:
    """(bytes, flops) that one apply of L levels to S solves per batch cannot
    do without: b read and x written once, the coefficients of
    :func:`coefficient_values` read once per batch; per solve a multiply and
    an add for each coefficient term, and the product with dinv."""
    outer, n, inner = line_view(tuple(grid), axis)
    lines, coef = B * outer * inner, coefficient_values(n, L)
    return itemsize * lines * (2 * S * n + coef), S * lines * (2 * coef - n)


def _shapes(F: torch.Tensor, b: torch.Tensor, axis: int):
    """(B, S, grid) of a stacked factor tensor and a right-hand side; raises
    ValueError when they do not belong together."""
    grid = tuple(F.shape[2:])
    B = F.shape[0] if F.ndim >= 3 else 0
    if F.ndim < 3 or F.shape[1] < 3 or F.shape[1] % 2 == 0:
        raise ValueError(f"expected F (B, 2L+1, *grid) with L >= 1, got {tuple(F.shape)}")
    if not -len(grid) <= axis < 0:
        raise ValueError(f"axis {axis} is not an axis of the grid {grid}")
    if b.ndim == F.ndim and tuple(b.shape[2:]) == grid and b.shape[0] == B:
        return B, b.shape[1], grid
    if b.ndim == F.ndim - 1 and tuple(b.shape[1:]) == grid and b.shape[0] == B:
        return B, 1, grid
    raise ValueError(
        f"b {tuple(b.shape)} is neither (B, S, *grid) nor (B, *grid) for F {tuple(F.shape)}"
    )


def pcr_apply_lines_plain(F: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """The plain version: ``ops.lines.pcr_apply`` on the levels of F (views),
    broadcast over the solve axis of b where it has one."""
    B, S, grid = _shapes(F, b, axis)
    steps, dinv = _lines.split_factors(F, 1)
    if b.ndim == F.ndim:
        steps = [(al.unsqueeze(1), be.unsqueeze(1)) for al, be in steps]
        dinv = dinv.unsqueeze(1)
    return _lines.pcr_apply(steps, dinv, b, axis=axis)


def _check(F: torch.Tensor, b: torch.Tensor, axis: int):
    B, S, grid = _shapes(F, b, axis)
    if b.dtype not in _ENTRY or F.dtype != b.dtype:
        raise ValueError(f"dtypes {F.dtype}/{b.dtype}: need float32 or float64, equal")
    if not (F.is_contiguous() and b.is_contiguous()):
        raise ValueError("F and b must be contiguous")
    if max(B, S, *line_view(grid, axis)) >= 2**31:
        raise ValueError(f"F {tuple(F.shape)} exceeds the kernel's int sizes")
    n = line_view(grid, axis)[1]
    if 2 * b.element_size() * S * n > MAX_SMEM_BYTES:
        raise ValueError(f"a line of {n} nodes and {S} solves needs "
                         f"{2 * b.element_size() * S * n} B of shared memory, more than a "
                         f"block's {MAX_SMEM_BYTES}")
    return B, S, grid


def kernel_info(B: int, S: int, grid, axis: int, dtype: torch.dtype = torch.float32) -> dict:
    """Registers, spill bytes, shared memory per block, lines per tile (in
    ``tile_rows``), solves (``solves_per_group``, always S) and resident
    blocks per SM of a launch
    of B batches of S solves on ``grid`` with lines along ``axis``."""
    return build.kernel_info(_INFO_ENTRY[dtype], B, S, *line_view(tuple(grid), axis))


def pcr_apply_lines(F: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """x = T^{-1} b for the tridiagonal lines along ``axis`` (negative, into
    the grid), from their stacked PCR factors.

    F: (B, 2L+1, *grid) from ``ops.lines.pcr_factor_stacked`` (alpha_k, beta_k,
    ..., dinv); b: (B, S, *grid) or (B, *grid). Tensors on the CPU take the
    plain version; any other launches K3 or raises (no autograd).
    """
    global LAUNCHES, CAPTURED
    if F.device.type == "cpu" and b.device.type == "cpu":
        return pcr_apply_lines_plain(F, b, axis)
    B, S, grid = _check(F, b, axis)
    lib = build.load_library()
    if b.device.type != "cuda" or F.device != b.device:
        raise ValueError(f"the kernel needs CUDA tensors on one device, got {F.device}, {b.device}")
    x = torch.empty_like(b)
    outer, n, inner = line_view(grid, axis)
    with torch.cuda.device(b.device):
        capturing = torch.cuda.is_current_stream_capturing()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _ENTRY[b.dtype])(
            F.data_ptr(), b.data_ptr(), x.data_ptr(), B, S, outer, n, inner,
            (F.shape[1] - 1) // 2, stream,
        )
    if err != 0:
        raise RuntimeError(f"pcr_lines launch failed: CUDA error {err}")
    if capturing:
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return x
