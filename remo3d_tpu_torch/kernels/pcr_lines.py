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
lines of one batch, holds all S solves of the tile in shared memory through
every level, streams each level's coefficients into shared memory with
``cp.async`` ahead of the level, and writes x once: the per-level
intermediate never reaches device memory. Strided lines take rows of at
least 32 bytes along inner and are split over the blocks of a thread-block
cluster, every cluster-th node in each block: the first log2(cluster) levels
read their neighbours from the other blocks' shared memory (distributed
shared memory), the later ones find them in their own. :func:`tile_plan`
decides the tile here, where the CPU tests see it; the kernel only checks
it. A launch for which no plan fits a block's shared memory is refused. The
coefficients keep the solve's dtype (the Pallas kernels stored them in
bfloat16), and every product and sum is rounded on its own in the plain
version's order.

With ``scale`` (and ``base``) the same launch writes the 3D ADI sweep's
damped step, base + scale x, instead of x (the step epilogue, an
instantiation of its own; ``base`` may be the output, updated in place): the
sweep's multiply, add and copy of x never reach device memory.

:func:`pcr_apply_lines` sends tensors that lie on the CPU to the plain
version; any other tensor launches the kernel or raises. There is no fallback
from a failed build or launch. It records no autograd graph: its callers (the
multigrid smoother and the 3D ADI sweep) run inside ``ops.cg.pcg``'s
``torch.no_grad``, or build the preconditioner from a detached operator.
"""

from __future__ import annotations

import ctypes
import functools
import sys
import types
from typing import NamedTuple

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
# Of those, the launches with the step epilogue (the ADI sweep's damped
# steps), counted the same way.
FUSED = types.SimpleNamespace(LAUNCHES=0, CAPTURED=0)
COUNTED.append(FUSED)

# A block's shared memory on sm_90 (slab::kMaxSmemBytes in csrc/slab_stage.cuh).
MAX_SMEM_BYTES = 232448
# The automatic tile (tile_plan) is the candidate of least estimated time on
# an H100: SM_COUNT SMs, each holding at most BLOCKS_PER_SM blocks (the
# kernel's __launch_bounds__) and SM_SMEM_BYTES of shared memory (1 KB of it
# reserved per block). A block costs its nodes, each weighted by its bytes
# (S solves and COEF_WEIGHT solves' worth of coefficients, in float32
# values), CLUSTER_COST more for each level that reads another block's
# shared memory and ROWS_COST more where the tile is rows, not whole runs of
# memory, and BLOCK_COST more for its start (launch, the first loads, the
# last stores); the blocks resident on an SM share it, at the EFFICIENCY of
# so many blocks (fewer hide less latency), and a launch takes whole waves.
# Strided lines take rows of ROW_BYTES or more along inner and are split
# over a cluster of 2 to MAX_CLUSTER blocks (the portable size). The
# constants are fitted to chip_smoke.py --tune's sweep of every line shape
# of both logs, float32 and float64.
SM_COUNT = 132
BLOCKS_PER_SM = 3
SM_SMEM_BYTES = 233472
BLOCK_COST = 6000
COEF_WEIGHT = 5
CLUSTER_COST = 0.1
ROWS_COST = 0.8
EFFICIENCY = {1: 0.73, 2: 0.90, 3: 1.0}
ROW_BYTES = 32
MAX_CLUSTER = 8
# Lines along inner up to which a tile takes all of inner (one run of memory).
RUN_INNER = 64


class Plan(NamedTuple):
    """A launch's tile (``csrc/pcr_lines.cu`` struct Plan, in this order).

    A tile holds ``TO`` x ``TI`` lines (outer x inner; ``tiles_o`` and
    ``tiles_i`` tiles split each evenly, so a tile is at most that wide);
    ``cluster`` blocks (a power of two) share a tile, block c holding nodes
    c, c + cluster, c + 2 cluster, ... of each of its lines, at most ``seg``;
    ``stages`` coefficient slots (more than the levels run: all of them
    staged at once); ``smem`` bytes of shared memory per block."""

    TO: int
    TI: int
    tiles_o: int
    tiles_i: int
    cluster: int
    seg: int
    stages: int
    smem: int


PLAN_FIELDS = Plan._fields

_ENTRY = {torch.float32: "pcr_lines_f32", torch.float64: "pcr_lines_f64"}
_INFO_ENTRY = {torch.float32: "pcr_lines_info_f32", torch.float64: "pcr_lines_info_f64"}
_STEP_ENTRY = {torch.float32: "pcr_lines_step_f32", torch.float64: "pcr_lines_step_f64"}
_STEP_INFO_ENTRY = {torch.float32: "pcr_lines_step_info_f32",
                    torch.float64: "pcr_lines_step_info_f64"}


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


def levels_run(n: int, L: int) -> int:
    """Levels of an L-level factor that change a line of n nodes: s = 2^k < n."""
    return sum(1 for k in range(L) if 2**k < n)


def smem_bytes(S: int, n: int, L: int, itemsize: int, TO: int, TI: int, seg: int,
               stages: int) -> int:
    """Shared memory of a block (``csrc/pcr_lines.cu`` plan_smem): x of the S
    solves twice, TO x seg x TI nodes each rounded up to 16 bytes, and the
    coefficient slots, two planes per stage (2 Lr + 1 planes, Lr the levels
    run, when every level is staged at once), each with 16 bytes of room for
    its placement."""
    V = 16 // itemsize
    nodes = TO * seg * TI
    x_cap = -(-nodes // V) * V
    c_cap = (nodes + 2 * V - 2) // V * V
    Lr = levels_run(n, L)
    planes = 2 * Lr + 1 if stages > Lr else 2 * stages
    return itemsize * (2 * S * x_cap + planes * c_cap)


def make_plan(S: int, outer: int, n: int, inner: int, L: int, itemsize: int, tiles_o: int,
              tiles_i: int, cluster: int, stages: int) -> Plan:
    """The plan of ``tiles_o`` x ``tiles_i`` tiles (even splits), each line
    split over ``cluster`` blocks, ``stages`` coefficient slots."""
    TO, TI, seg = -(-outer // tiles_o), -(-inner // tiles_i), -(-n // cluster)
    return Plan(TO, TI, tiles_o, tiles_i, cluster, seg, stages,
                smem_bytes(S, n, L, itemsize, TO, TI, seg, stages))


def occupancy(smem: int) -> int:
    """Blocks of ``smem`` bytes of shared memory resident on one SM."""
    return max(1, min(BLOCKS_PER_SM, SM_SMEM_BYTES // (smem + 1024)))


def estimated_cost(B: int, S: int, itemsize: int, plan: Plan) -> float:
    """The cost model of :func:`tile_plan` for B batches of S solves of
    ``itemsize`` bytes, in float32 node-solve times of one SM: the waves of
    the launch, each as long as its blocks' work (weighted nodes, CLUSTER_COST
    per remote level, ROWS_COST for rows, BLOCK_COST) times the blocks
    sharing an SM, over their EFFICIENCY."""
    occ = occupancy(plan.smem)
    blocks = B * plan.tiles_o * plan.tiles_i * plan.cluster
    rows = plan.cluster > 1 or plan.tiles_i > 1
    per_node = (S + COEF_WEIGHT) * itemsize / 4 * (
        1 + CLUSTER_COST * (plan.cluster.bit_length() - 1) + (ROWS_COST if rows else 0))
    work = occ * (plan.TO * plan.TI * plan.seg * per_node + BLOCK_COST) / EFFICIENCY[occ]
    return -(-blocks // (SM_COUNT * occ)) * work


@functools.lru_cache(maxsize=None)
def tile_plan(B: int, S: int, outer: int, n: int, inner: int, L: int,
              itemsize: int) -> Plan | None:
    """The tile of a launch of B batches of S solves on lines (outer, n,
    inner) with L levels: of :func:`candidate_plans` the one of least
    :func:`estimated_cost`; None when none fits a block's shared memory.
    Cached: a launch's host time is the launch, not the search (hundreds of
    candidates on the 3D z lines)."""
    plans = candidate_plans(S, outer, n, inner, L, itemsize)
    return min(plans, key=lambda p: (estimated_cost(B, S, itemsize, p), p.smem), default=None)


def candidate_plans(S: int, outer: int, n: int, inner: int, L: int, itemsize: int) -> list:
    """The plans :func:`tile_plan` chooses from, each fitting a block's
    shared memory. Where inner is at most RUN_INNER (r and p lines), tiles of
    whole lines with all of inner (one run of memory per plane), 1 to
    ``outer`` lines along outer, coefficients in a ring of two stages or all
    at once; where inner is more than 1 (z and p lines), or no whole line
    fits a block, strided rows of ROW_BYTES or more along inner, each line
    split over a cluster of 2, 4 or 8 blocks (at most n), a ring of two
    stages (all at once with one level)."""
    Lr = levels_run(n, L)
    stages = sorted({min(2, Lr + 1), Lr + 1})
    plans = []
    if inner <= RUN_INNER:
        for st in stages:
            for TO in range(1, outer + 1):
                p = make_plan(S, outer, n, inner, L, itemsize, -(-outer // TO), 1, 1, st)
                if p.smem > MAX_SMEM_BYTES:
                    break
                plans.append(p)
    if inner > 1 or not plans:
        row = max(1, ROW_BYTES // itemsize)
        clusters = [c for c in (2, 4, 8) if c <= n] or [1]
        for tiles_i in range(1, max(1, inner // row) + 1):
            for c in clusters:
                p = make_plan(S, outer, n, inner, L, itemsize, outer, tiles_i, c, stages[0])
                if p.smem <= MAX_SMEM_BYTES:
                    plans.append(p)
    return plans


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


def _check_step(b: torch.Tensor, scale, base, out) -> None:
    """Raises ValueError where the step epilogue's ``base`` or the ``out``
    tensor does not belong to b, or ``base`` comes without ``scale``."""
    if base is not None and scale is None:
        raise ValueError("base needs a scale")
    for name, t in (("base", base), ("out", out)):
        if t is not None and (t.shape != b.shape or t.dtype != b.dtype or t.device != b.device):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on {t.device} is not like b "
                             f"{tuple(b.shape)} {b.dtype} on {b.device}")


def pcr_apply_lines_plain(F: torch.Tensor, b: torch.Tensor, axis: int, *, scale=None,
                          base=None, out=None) -> torch.Tensor:
    """The plain version: ``ops.lines.pcr_apply`` on the levels of F (views),
    broadcast over the solve axis of b where it has one; with ``scale``,
    ``base + scale * x`` (or ``scale * x``), each op rounded on its own as
    the kernel's epilogue does. Written into ``out`` if given (it may be
    ``base``)."""
    _check_step(b, scale, base, out)
    B, S, grid = _shapes(F, b, axis)
    steps, dinv = _lines.split_factors(F, 1)
    if b.ndim == F.ndim:
        steps = [(al.unsqueeze(1), be.unsqueeze(1)) for al, be in steps]
        dinv = dinv.unsqueeze(1)
    x = _lines.pcr_apply(steps, dinv, b, axis=axis)
    if scale is not None:
        x = scale * x
        if base is not None:
            x = base + x
    return x if out is None else out.copy_(x)


def _check(F: torch.Tensor, b: torch.Tensor, axis: int):
    B, S, grid = _shapes(F, b, axis)
    if b.dtype not in _ENTRY or F.dtype != b.dtype:
        raise ValueError(f"dtypes {F.dtype}/{b.dtype}: need float32 or float64, equal")
    if not (F.is_contiguous() and b.is_contiguous()):
        raise ValueError("F and b must be contiguous")
    outer, n, inner = line_view(grid, axis)
    if max(B, S, outer * n * inner) >= 2**31:
        raise ValueError(f"F {tuple(F.shape)} exceeds the kernel's int sizes")
    plan = tile_plan(B, S, outer, n, inner, (F.shape[1] - 1) // 2, b.element_size())
    if plan is None:
        raise ValueError(f"no tile of a line of {n} nodes and {S} solves fits a block's "
                         f"{MAX_SMEM_BYTES} B of shared memory, even split over a cluster "
                         f"of {MAX_CLUSTER}")
    return plan


def _plan_arg(plan: Plan):
    return (ctypes.c_int * len(PLAN_FIELDS))(*plan)


def kernel_info(B: int, S: int, grid, axis: int, L: int,
                dtype: torch.dtype = torch.float32, step: bool = False) -> dict:
    """Registers, spill bytes, shared memory per block, lines per tile (in
    ``tile_rows``), solves (``solves_per_group``, always S) and resident
    blocks per SM of a launch of B batches of S solves on ``grid`` with lines
    along ``axis`` and L levels (with ``step``, of the step epilogue's
    instantiation), and the fields of its :func:`tile_plan`."""
    outer, n, inner = line_view(tuple(grid), axis)
    plan = tile_plan(B, S, outer, n, inner, L, torch.empty((), dtype=dtype).element_size())
    entry = (_STEP_INFO_ENTRY if step else _INFO_ENTRY)[dtype]
    info = build.kernel_info(entry, B, S, outer, n, inner, L, _plan_arg(plan))
    return {**info, **plan._asdict()}


def launch(lib, F: torch.Tensor, b: torch.Tensor, x: torch.Tensor, axis: int,
           plan: Plan | None = None, *, scale=None, base=None) -> None:
    """One launch of the kernel in ``lib`` (the package's library or a probe
    build) on the current stream, x = T^{-1} b (with ``scale``, the step
    epilogue's x = base + scale T^{-1} b; ``base`` may be x), with ``plan``
    (else :func:`tile_plan`'s); raises on a CUDA error (a plan the kernel
    cannot run is one). Counts nothing: :func:`pcr_apply_lines` does."""
    B, S, grid = _shapes(F, b, axis)
    outer, n, inner = line_view(grid, axis)
    L = (F.shape[1] - 1) // 2
    if plan is None:
        plan = tile_plan(B, S, outer, n, inner, L, b.element_size())
    args = (B, S, outer, n, inner, L, _plan_arg(plan), torch.cuda.current_stream().cuda_stream)
    if scale is None:
        err = getattr(lib, _ENTRY[b.dtype])(F.data_ptr(), b.data_ptr(), x.data_ptr(), *args)
    else:
        err = getattr(lib, _STEP_ENTRY[b.dtype])(
            F.data_ptr(), b.data_ptr(), x.data_ptr(), None if base is None else base.data_ptr(),
            float(scale), *args)
    if err != 0:
        raise RuntimeError(f"pcr_lines launch failed: CUDA error {err}")


def pcr_apply_lines(F: torch.Tensor, b: torch.Tensor, axis: int, *, scale=None, base=None,
                    out=None) -> torch.Tensor:
    """x = T^{-1} b for the tridiagonal lines along ``axis`` (negative, into
    the grid), from their stacked PCR factors; with ``scale``, the step
    ``base + scale * x`` (``scale * x`` without ``base``) in the same launch.

    F: (B, 2L+1, *grid) from ``ops.lines.pcr_factor_stacked`` (alpha_k, beta_k,
    ..., dinv); b: (B, S, *grid) or (B, *grid); ``base`` and ``out`` like b,
    ``out`` may be ``base`` (a new tensor without it). Tensors on the CPU take
    the plain version; any other launches K3 with :func:`tile_plan`'s plan or
    raises (no autograd). A launch with ``scale`` counts in :data:`FUSED`
    too.
    """
    global LAUNCHES, CAPTURED
    if F.device.type == "cpu" and b.device.type == "cpu":
        return pcr_apply_lines_plain(F, b, axis, scale=scale, base=base, out=out)
    plan = _check(F, b, axis)
    _check_step(b, scale, base, out)
    if not all(t is None or t.is_contiguous() for t in (base, out)):
        raise ValueError("base and out must be contiguous")
    lib = build.load_library()
    if b.device.type != "cuda" or F.device != b.device:
        raise ValueError(f"the kernel needs CUDA tensors on one device, got {F.device}, {b.device}")
    x = torch.empty_like(b) if out is None else out
    with torch.cuda.device(b.device):
        capturing = torch.cuda.is_current_stream_capturing()
        launch(lib, F, b, x, axis, plan, scale=scale, base=base)
    if capturing:
        CAPTURED += 1
        FUSED.CAPTURED += scale is not None
    else:
        LAUNCHES += 1
        FUSED.LAUNCHES += scale is not None
    return x
