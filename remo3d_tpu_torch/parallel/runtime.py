# -*- coding: utf-8 -*-
"""Batched solve executor on one torch device (a CUDA card or the CPU) per
process.

Counterpart of ``remo3d_tpu.parallel.runtime`` for the 2D axisymmetric path
(multigrid or block-direct PCG) and the 3D dipping-layer path (ADI line or
block-direct PCG). All batch meshes of a chunk are stacked into fixed-shape
tensors and solved together (assembly + batched PCG + axis readout); solves
are uniform in cost by construction (fixed topology), so chunks are padded
with benign lanes instead of being scheduled dynamically. Under several
processes (``parallel/distributed.py``) each chunk is split over the ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..kernels import pcr_lines
from ..kernels.stencil3d import half_planes_3d, stencil3d_apply_half
from ..meshing.carve import carve_local_model
from ..meshing.device_mesh import device_mesh_2d
from ..meshing.grid2d import Grid2DLight, GridSpec2D, build_grid2d, build_grid2d_light
from ..meshing.grid3d import Grid3D, GridSpec3D, build_grid3d
from ..meshing.native import build_grid2d_native, build_grid3d_native, load_error, native_available
from ..ops.assembly2d import (
    apply_dirichlet,
    element_matrices_2d,
    fold_to_stencil,
    fundamental_potential_2d,
    singularity_rhs_2d,
)
from ..ops.assembly3d import (
    apply_dirichlet_3d,
    element_matrices_3d,
    fold_to_stencil_3d,
    fundamental_potential_3d,
    singularity_rhs_3d,
)
from ..ops.block_bcr import bcr_apply, bcr_factor
from ..ops.block_bcr3d import bcr_apply_3d, bcr_factor_3d
from ..ops.block_direct import (
    block_thomas_apply,
    block_thomas_factor,
    schur_fixedpoint_factor,
)
from ..ops.block_direct3d import (
    block_thomas_apply_3d,
    block_thomas_factor_3d,
    schur_fixedpoint_factor_3d,
)
from ..ops.cg import pcg, solve_stream
from ..ops.lines3d import line_apply3, line_factor3
from ..ops.multigrid import MGConfig, make_mg_preconditioner, make_stencil_apply
from ..ops.stencil import stencil_apply
from ..ops.stencil3d import pole_project, pole_tie_, stencil3d_apply
from ..planner import BatchTask
from ..utils.timers import PhaseTimers, entered, request_context, span
from . import distributed

MAX_SOURCES = 2  # per solve: one (+1) in SEC form or a (+1, -1) pair


def _feasible_mg_levels(*dims: int, want: int = 4) -> int:
    levels = 1
    step = 1
    while levels < want and all((n - 1) % (2 * step) == 0 for n in dims):
        levels += 1
        step *= 2
    return levels


def _solve_chunk(
    coords, sigma, free, src_i, src_fac, *, tol, maxiter, preconditioner,
    subtract=True, use_kernel=True, mg_degree=3, mg_power_iters=12,
    mg_line_steps=None, mg_smoother="line_rz", timings=None,
):
    """Assemble + batched PCG + axis-potential extraction for one chunk.

    coords (B, NZ, NR, 2), sigma (B, NZ-1, NR-1), free (B, NZ, NR) bool,
    src_i (B, S, MAX_SOURCES) int64, src_fac (B, S, MAX_SOURCES).
    Returns (u_axis (B, S, NZ), rel_residual (B, S), iterations (int)).

    With ``subtract`` (default) the point-source singularity is removed
    analytically: we solve for the smooth correction w = u - u_s with the load
    ``-∫2·pi·r(sigma-sigma0)grad(u_s)·grad(v)`` and an inhomogeneous Dirichlet lift
    w = -u_s on the truncation circle.

    ``use_kernel`` routes the CG matvec and the two finest multigrid levels
    through the half-storage stencil wrapper (the CUDA kernel on CUDA tensors).
    ``timings``, if a dict, gets the CG loop's graph figures (:func:`_pcg2`).
    """
    nz, nr = coords.shape[-3], coords.shape[-2]

    # Assemble once; keep the raw stencil for the boundary-lift product and derive
    # the eliminated system + MG hierarchy from it.
    with span("assemble"):
        C_raw = fold_to_stencil(element_matrices_2d(coords, sigma), nz, nr)
        C_fine = apply_dirichlet(C_raw, free)
        n_levels = _feasible_mg_levels(nz, nr)
        if preconditioner == "multigrid" and n_levels > 1:
            C, M_inv = make_mg_preconditioner(
                coords,
                sigma,
                free,
                MGConfig(
                    n_levels=n_levels,
                    kernel_levels=2 if use_kernel else 0,
                    degree_pre=mg_degree,
                    degree_post=mg_degree,
                    power_iters=mg_power_iters,
                    line_max_steps=mg_line_steps,
                    smoother=mg_smoother,
                ),
                C_fine=C_fine,
            )
        else:
            # "local" preconditioner parity (ngsolve_functions.py:46): point Jacobi.
            C = C_fine
            M_inv = None
        matvec = make_stencil_apply(C, True) if use_kernel else None
        b, known = _load2(C_raw, coords, sigma, free, src_i, src_fac, subtract)
    return _pcg2(C, b, known, M_inv, matvec, tol=tol, maxiter=maxiter, timings=timings)


def _build_rhs2_subtract(coords, sigma, free, src_i, src_fac, C_raw):
    """Singularity-subtracted 2D load with the boundary lift.

    Returns (rhs, g_lift, u_s): the solution is u = w + g_lift + u_s with
    A w = rhs. The lift uses the RAW stencil ``C_raw``: the eliminated one has
    no couplings into the Dirichlet nodes.
    """
    nz = coords.shape[-3]
    freeb = free[:, None]  # broadcast over the solve axis
    sigma0 = sigma[:, 0, 0]  # borehole column = mud conductivity
    z_axis = coords[:, :, 0, 0]  # (B, NZ)
    B, S = src_i.shape[:2]
    src_z = torch.gather(z_axis[:, None, :].expand(B, S, nz), 2, src_i)  # (B, S, K)
    u_s = fundamental_potential_2d(coords, sigma0, src_z, src_fac)
    rhs = singularity_rhs_2d(coords, sigma, sigma0, src_z, src_fac)
    g_lift = torch.where(freeb, torch.zeros_like(u_s), -u_s)
    rhs = rhs - stencil_apply(C_raw, g_lift)
    return torch.where(freeb, rhs, torch.zeros_like(rhs)), g_lift, u_s


def _load2(C_raw, coords, sigma, free, src_i, src_fac, subtract):
    """The load b of a 2D chunk and the known parts of its solution: u = w +
    known[0] + ..., where A w = b (``subtract``: the singularity-subtracted
    load, :func:`_build_rhs2_subtract`; else the point loads, nothing known).
    ``C_raw`` is the assembled stencil."""
    if subtract:
        rhs, g_lift, u_s = _build_rhs2_subtract(coords, sigma, free, src_i, src_fac, C_raw)
        return rhs, (g_lift, u_s)
    nz, nr = coords.shape[-3], coords.shape[-2]
    b = torch.zeros(tuple(src_i.shape[:2]) + (nz, nr), dtype=coords.dtype, device=coords.device)
    for k in range(src_i.shape[-1]):
        b[..., 0].scatter_add_(-1, src_i[..., k : k + 1], src_fac[..., k : k + 1])
    return b, ()


def _pcg2(C, b, known, M_inv, matvec, *, tol, maxiter, timings=None):
    """PCG + axis readout of a 2D chunk, whatever preconditions it.

    ``C`` is the Dirichlet-eliminated operator CG runs on, ``b`` and ``known``
    the load and the known parts of the solution (:func:`_load2`), ``M_inv``
    the preconditioner (None = point Jacobi) and ``matvec`` the operator apply
    (None = the plain 9-point apply of ``C``). ``timings``, if a dict, gets
    the CG loop's graph figures under "graph" (:func:`_graph_figures`).
    """
    with span("cg") as figures:
        u, info = pcg(C, b, M_inv=M_inv, tol=tol, maxiter=maxiter, matvec=matvec)
        figures.update({k: info[k] for k in ("iterations", "replays", "capture_seconds")})
    for part in known:
        u = u + part
    _graph_figures(timings, info)
    # Axis potentials are all the readout needs (electrodes sit on axis nodes).
    return u[..., 0], info["rel_residual"], info["iterations"]


def _graph_figures(timings: dict | None, info: dict) -> None:
    """``timings["graph"]`` = the CG loop's capture seconds and replays (both
    0 when it ran op by op), when ``timings`` is a dict."""
    if timings is not None:
        timings["graph"] = {k: info[k] for k in ("capture_seconds", "replays")}


@contextlib.contextmanager
def _timed(timings: dict | None, name: str, device: torch.device,
           timers: PhaseTimers | None = None):
    """Time the block, inside the span ``name`` (a phase of ``timers``, by
    default of the enclosing span's: :func:`~remo3d_tpu_torch.utils.timers.span`).
    ``timings[name]`` becomes a function that returns the block's seconds
    (``timings`` None: no such function). On the CPU that is the host's clock. On
    a CUDA device the block lies between two events of the current stream, so
    queued work is neither counted in nor left out and the host never waits;
    the function may be called once the device has passed the second event,
    as after the ``.cpu()`` of the chunk's results."""
    with span(name, timers=timers):
        if timings is None:
            yield
        elif device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            timings[name] = lambda: start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            yield
            seconds = time.perf_counter() - t0
            timings[name] = lambda: seconds


def _factor2_direct(C, *, schedule="scan", passes=None):
    """Factorize the 2D block-tridiagonal operator; returns the function
    r -> M^{-1} r that applies the factorization (and alone holds it).

    ``schedule``: "scan" = the exact sequential block-LDL^T chain; "bcr" =
    exact block cyclic reduction (log-depth batched stages,
    ``ops/block_bcr.py``); "fp" = the batched Schur fixed-point approximation
    with ``passes`` whole-stack inversions (8 when None): a valid SPD
    preconditioner at any pass count, but the truncated chain converges slowly
    on long grids, so CG takes many more iterations than with an exact factor.
    ``passes`` means nothing to the exact schedules."""
    if schedule == "bcr":
        factors = bcr_factor(C)
        return lambda r: bcr_apply(factors, r)
    if schedule == "fp":
        G_all = schur_fixedpoint_factor(C, passes=8 if passes is None else passes)
    else:
        G_all = block_thomas_factor(C)
    return lambda r: block_thomas_apply(G_all, C, r)


def _solve_chunk_direct(
    coords, sigma, free, src_i, src_fac, *, tol, maxiter, subtract=True,
    use_kernel=True, schedule="scan", factor_passes=None, timings=None,
):
    """2D chunk solve through the block-direct preconditioner: assembly, one
    factorization of the chunk's operators, then PCG with the factorization's
    apply as M^{-1} (a handful of iterations) and the axis readout.

    Arguments and returns as :func:`_solve_chunk`. ``use_kernel`` routes the CG
    matvec through the half-storage stencil wrapper (the CUDA kernel on CUDA
    tensors). ``timings``, if a dict, gets the factorization's time under
    "factor" (:func:`_timed`) and the CG loop's graph figures (:func:`_pcg2`).
    """
    nz, nr = coords.shape[-3], coords.shape[-2]
    with span("assemble"):
        C_raw = fold_to_stencil(element_matrices_2d(coords, sigma), nz, nr)
        C = apply_dirichlet(C_raw, free)
        with _timed(timings, "factor", C.device):
            M_inv = _factor2_direct(C, schedule=schedule, passes=factor_passes)
        matvec = make_stencil_apply(C, True) if use_kernel else None
        b, known = _load2(C_raw, coords, sigma, free, src_i, src_fac, subtract)
    return _pcg2(C, b, known, M_inv, matvec, tol=tol, maxiter=maxiter, timings=timings)


def _assemble3(coords, sigma, free, metric="cartesian"):
    """Q1 hex assembly -> raw and Dirichlet-eliminated 27-point stencils."""
    nz, np_, nr = coords.shape[-4], coords.shape[-3], coords.shape[-2]
    C_raw = fold_to_stencil_3d(element_matrices_3d(coords, sigma, metric=metric), nz, np_, nr)
    return C_raw, apply_dirichlet_3d(C_raw, free)


def _apply3(C, use_kernel: bool, pole: bool = False):
    """The operator of stencil C: the half-storage wrapper (the CUDA kernel on
    CUDA tensors) or the full 27-plane apply. With ``pole`` it is the pole-tied
    operator P A P, P = :func:`pole_project`: one wrapper call (the kernel ties
    the pole on the slab it holds), or the plain apply between two projections."""
    if use_kernel:
        C_half = half_planes_3d(C)
        return lambda u: stencil3d_apply_half(C_half, u, pole=pole)
    if pole:
        return lambda u: pole_project(stencil3d_apply(C, pole_project(u)))
    return lambda u: stencil3d_apply(C, u)


def _build_rhs3_subtract(coords, sigma, free, src_i, src_fac, apply_raw, metric="cartesian"):
    """Singularity-subtracted load + boundary lift + axis offset field.

    ``apply_raw`` applies the RAW stencil (the eliminated one has no couplings
    into the Dirichlet nodes). Returns (rhs, u_axis_offset), where
    ``u_axis_offset`` is the (g_lift + u_s) part of the solution on the axis.
    """
    nz = coords.shape[-4]
    freeb = free[:, None]
    sigma0 = sigma[:, 0, 0, 0]  # innermost ring = mud conductivity
    z_axis = coords[:, :, 0, 0, 2]  # (B, NZ) physical z on the borehole axis
    B, S = src_i.shape[:2]
    src_z = torch.gather(z_axis[:, None, :].expand(B, S, nz), 2, src_i)  # (B, S, K)
    u_s = fundamental_potential_3d(coords, sigma0, src_z, src_fac)
    rhs = singularity_rhs_3d(coords, sigma, sigma0, src_z, src_fac, metric=metric)
    g_lift = torch.where(freeb, torch.zeros_like(u_s), -u_s)
    rhs = rhs - apply_raw(g_lift)
    rhs = pole_project(torch.where(freeb, rhs, torch.zeros_like(rhs)))
    return rhs, (g_lift + u_s)[..., :, 0, 0]


def _factor3_direct(C, *, np_, nr, schedule="scan", passes=None):
    """Factorize the 3D banded-block-tridiagonal operator; ``schedule``,
    ``passes`` and the returned apply as in :func:`_factor2_direct` ("bcr":
    ``ops/block_bcr3d.py``). The apply leaves the axis DOFs untied."""
    if schedule == "bcr":
        factors = bcr_factor_3d(C, np_, nr)
        return lambda r: bcr_apply_3d(factors, r, np_, nr)
    if schedule == "fp":
        G_all = schur_fixedpoint_factor_3d(C, np_, nr, passes=8 if passes is None else passes)
    else:
        G_all = block_thomas_factor_3d(C, np_, nr)
    return lambda r: block_thomas_apply_3d(G_all, C, r, np_, nr)


def _precond3(C, matvec, direct_apply=None, precond="adi", adi_damp=0.6):
    """The preconditioner M^{-1} of the pole-tied CG on stencil C.

    ``matvec`` is the pole-tied operator P A P (``_apply3(C, use_kernel,
    pole=True)``). Preconditioners (the line solves are exact, factored PCR):

    * ``"adi"``: damped symmetric multiplicative sweep z-p-r-p-z; the damping
      keeps the sweep contractive (undamped, modes with rho(T^-1 A) > 2
      diverge). Each application runs the operator 4 times. Each line solve
      writes the sweep's next iterate itself, z + w T^-1 res (``line_apply3``
      with ``scale`` and ``base``: on the card in K3's launch, z updated in
      place), and then only the axis column is tied (:func:`pole_tie_`): z is
      tied already, so that is P(z + w y) = z + w P(y), the JAX package's
      expression, up to the rounding of the axis column.
    * ``"lines"``: additive average of the three line solves.
    * ``"direct"``: ``direct_apply``, the banded-block factorization's apply
      from :func:`_factor3_direct`. It leaves the axis DOFs untied, so
      M^{-1} r = P apply(P r): a handful of CG iterations.
    """
    if precond == "direct":
        def M_inv(r):
            return pole_project(direct_apply(pole_project(r)))
    else:
        factors = {d: line_factor3(C, d) for d in ("z", "p", "r")}
        if precond == "adi":
            def M_inv(r):
                r = pole_project(r)
                z = pole_tie_(line_apply3(factors["z"], r, scale=adi_damp))
                for d in ("p", "r", "p", "z"):
                    res = r - matvec(z)
                    pole_tie_(line_apply3(factors[d], res, scale=adi_damp, base=z, out=z))
                return z
        else:
            def M_inv(r):
                r = pole_project(r)
                z = sum(line_apply3(factors[d], r) for d in factors) / 3.0
                return pole_project(z)
    return M_inv


def _cg3(b, u_axis_offset, matvec, M_inv, *, tol, maxiter, timings=None):
    """Pole-tied PCG + axis readout of a 3D chunk (``matvec`` and ``M_inv``
    as :func:`_precond3`'s). ``timings``, if a dict, gets the CG loop's graph
    figures (:func:`_pcg2`)."""
    with span("cg") as figures:
        u, info = pcg(None, b, M_inv=M_inv, tol=tol, maxiter=maxiter, n_grid_axes=3,
                      matvec=matvec)
        figures.update({k: info[k] for k in ("iterations", "replays", "capture_seconds")})
    _graph_figures(timings, info)
    u_axis = u[..., :, :, 0].mean(dim=-1) + u_axis_offset
    return u_axis, info["rel_residual"], info["iterations"]


def _pcg3(C, b, u_axis_offset, matvec, direct_apply=None, *, tol, maxiter, precond="adi",
          adi_damp=0.6, timings=None):
    """Pole-tied preconditioned CG + axis readout, as the JAX package's
    ``_pcg3``: :func:`_precond3`'s ``precond`` of C, then :func:`_cg3`."""
    M_inv = _precond3(C, matvec, direct_apply, precond, adi_damp)
    return _cg3(b, u_axis_offset, matvec, M_inv, tol=tol, maxiter=maxiter, timings=timings)


def _solve_chunk_3d(
    coords, sigma, free, src_i, src_fac, *, tol, maxiter, subtract=True,
    precond="adi", adi_damp=0.6, use_kernel=True, schedule="scan", factor_passes=None,
    metric="cartesian", timings=None,
):
    """3D chunk solve: hex assembly + singularity subtraction + pole-tied CG.

    coords (B, NZ, NP, NR, 3), sigma (B, NZ-1, NP-1, NR-1), free (B, NZ, NP, NR),
    src_i (B, S, MAX_SOURCES) int64, src_fac (B, S, MAX_SOURCES).
    Returns (u_axis (B, S, NZ), rel_residual (B, S), iterations (int)).

    With ``subtract`` (default) the analytic half-space field
    ``fac/(2*pi*sigma0*d)`` of every source is removed, so CG solves only for
    the smooth heterogeneity correction. ``use_kernel`` routes every operator
    apply (the CG matvec, the ADI sweep and the boundary-lift product) through
    the half-storage stencil wrapper: the CUDA kernel on CUDA tensors, which
    also ties the pole around the matvec and the sweep's applies. With
    ``precond="direct"`` the operator is factorized once per chunk under
    ``schedule`` / ``factor_passes`` (:func:`_factor3_direct`); ``timings``, if
    a dict, gets the factorization's time under "factor" (:func:`_timed`) and
    the CG loop's graph figures (:func:`_pcg2`).
    """
    nz, np_, nr = coords.shape[-4], coords.shape[-3], coords.shape[-2]
    with span("assemble"):
        C_raw, C = _assemble3(coords, sigma, free, metric=metric)
        if subtract:
            b, u_axis_offset = _build_rhs3_subtract(
                coords, sigma, free, src_i, src_fac, _apply3(C_raw, use_kernel), metric=metric
            )
        else:
            # The load lands on the tied axis node: fac/NP on each azimuth copy.
            B, S = src_i.shape[:2]
            b_axis = torch.zeros((B, S, nz), dtype=coords.dtype, device=coords.device)
            b_axis.scatter_add_(-1, src_i, src_fac / np_)
            b = torch.zeros((B, S, nz, np_, nr), dtype=coords.dtype, device=coords.device)
            b[..., 0] = b_axis[..., None]
            u_axis_offset = torch.zeros_like(b_axis)
        direct_apply = None
        if precond == "direct":
            with _timed(timings, "factor", C.device):
                direct_apply = _factor3_direct(
                    C, np_=np_, nr=nr, schedule=schedule, passes=factor_passes)
        matvec = _apply3(C, use_kernel, pole=True)
        M_inv = _precond3(C, matvec, direct_apply, precond, adi_damp)
    return _cg3(b, u_axis_offset, matvec, M_inv, tol=tol, maxiter=maxiter, timings=timings)


_numpy_fallback_warned = False


def _warn_numpy_fallback() -> None:
    """Warn, once per process, that host meshing falls back to numpy."""
    global _numpy_fallback_warned
    if not _numpy_fallback_warned:
        _numpy_fallback_warned = True
        warnings.warn(
            f"native grid builder unavailable ({load_error()}); meshing with numpy",
            RuntimeWarning,
            stacklevel=3,
        )


def _split_axes(n_ranks: int, n_batches: int, n_solves: int) -> tuple[int, int]:
    """(ranks on the batch axis, ranks on the solve axis) for a run of
    ``n_batches`` batch meshes of ``n_solves`` solve slots each: the solve axis
    takes ranks only when batches are scarcer than ranks, and then the largest
    count that divides both the slots and the ranks (``runtime.py:749-756`` of
    the JAX package)."""
    n_solve_axis = 1
    if n_ranks > 1 and n_batches < n_ranks:
        spare = n_ranks // math.gcd(n_ranks, n_batches)
        for cand in range(min(n_solves, spare), 0, -1):
            if n_solves % cand == 0 and n_ranks % cand == 0:
                n_solve_axis = cand
                break
    return n_ranks // n_solve_axis, n_solve_axis


class LazyGrids:
    """Sequence of per-batch grids, built on first access and cached.

    Supports int and slice indexing and iteration, so eager-list call sites work
    unchanged, and :meth:`ensure` builds a range ahead of use. ``built`` holds
    the indices of the grids built so far.
    """

    def __init__(self, n: int, build_one):
        self._build = build_one
        self._cache: list = [None] * n
        self.built: set[int] = set()

    def __len__(self) -> int:
        return len(self._cache)

    def ensure(self, start: int = 0, stop: int | None = None) -> None:
        stop = len(self._cache) if stop is None else min(stop, len(self._cache))
        for i in range(max(start, 0), stop):
            if self._cache[i] is None:
                self._cache[i] = self._build(i)
                self.built.add(i)

    def __getitem__(self, i):
        if isinstance(i, slice):
            idx = range(*i.indices(len(self._cache)))
            for j in idx:
                self.ensure(j, j + 1)
            return [self._cache[j] for j in idx]
        if i < 0:
            i += len(self._cache)
        if not 0 <= i < len(self._cache):
            raise IndexError(i)
        self.ensure(i, i + 1)
        return self._cache[i]


@dataclasses.dataclass
class ExecutorConfig:
    spec: GridSpec2D = dataclasses.field(default_factory=GridSpec2D)
    spec3d: GridSpec3D = dataclasses.field(default_factory=GridSpec3D)
    tol: float = 1e-7
    maxiter: int = 1000
    dtype: str = "float32"
    # Torch device: "cuda", "cuda:N" or "cpu". None = "cuda"; without a visible
    # card that raises (there is no silent CPU run: pass "cpu" to ask for one).
    device: str | None = None
    # Batch meshes per chunk. None = auto: 96 on CUDA (a starting value, to be
    # re-screened on the card), 48 on the CPU.
    chunk_size: int | None = None
    # 3D batch meshes per chunk (each ~160k nodes on the default grid), scaled
    # down as chunk_size_3d * 5 // S for more than 5 solves per batch.
    chunk_size_3d: int = 8
    # 2D: "auto", "multigrid", "local" (point Jacobi) or "direct" (batched
    # block-LDL^T / cyclic reduction, ops/block_direct.py, ops/block_bcr.py).
    # "auto" is "direct" on the CPU, as in the JAX package, and "multigrid" on
    # CUDA (PERF.md holds the card's screen of the two).
    preconditioner: str = "auto"
    # 3D: "auto", "adi" (damped z-p-r-p-z line sweep), "lines" (additive) or
    # "direct" (banded-block LDL^T / cyclic reduction, ops/block_direct3d.py,
    # ops/block_bcr3d.py). "auto" is "direct" on the CPU and "adi" on CUDA.
    precond3d: str = "auto"
    # Schedule of the direct factorization, 2D and 3D: "scan" = the exact
    # sequential block-LDL^T chain (NZ dependent steps, and two NZ-step loops
    # per application); "bcr" = exact block cyclic reduction (log2(NZ) batched
    # stages for factor and apply, more memory); "fp" = the batched Schur
    # fixed-point approximation with direct_factor_passes whole-stack
    # inversions (SPD at any pass count, many more CG iterations on long
    # grids). "auto" is "bcr" on CUDA and "scan" on the CPU.
    direct_schedule: str = "auto"
    # "fp" pass count (None = 8). A value also selects "fp" unless the
    # schedule is given as "bcr".
    direct_factor_passes: int | None = None
    # 3D assembly metric: "cylindrical" (the hexes are the exact solid of
    # revolution through the nodes) or "cartesian" (chordal hexes).
    metric3d: str = "cylindrical"
    adi_damp: float = 0.6
    # Route every stencil apply of the solve (2D: the CG matvec and the two
    # finest MG levels; 3D: the CG matvec, the ADI sweep and the boundary-lift
    # product) through the half-storage wrappers: the CUDA kernels on CUDA
    # tensors, their plain versions on CPU tensors. False = the full 9-point
    # or 27-point plain apply everywhere.
    use_stencil_kernel: bool = True
    # 2D MG smoother: Chebyshev degree of pre/post smoothing, power iterations
    # of the per-batch spectral estimate, PCR truncation (None = exact), and
    # the inner smoother ("line_rz", "line_r" or "jacobi").
    mg_degree: int = 2
    mg_power_iters: int = 6
    mg_line_steps: int | None = None
    mg_smoother: str = "line_rz"
    # A solve is declared failed (NaN readouts, matching the reference's per-task
    # NaN containment) only above this attained relative residual.
    fail_residual: float = 1e-4
    # Host meshing (3D grids, and 2D grids without device meshing): the native
    # C++ builders (meshing/native.py) when g++ can build them, else the numpy
    # ones with a warning; last_report["mesher"] says which ran.
    use_native_mesher: bool = True
    # Build the 2D grids on the device from 1D profiles (meshing/device_mesh.py)
    # instead of staging host-built arrays. None = auto: on for CUDA, off on CPU.
    device_meshing: bool | None = None
    # A torch.profiler trace of the chunk loop (CPU activities, and CUDA ones
    # on a card), written into this directory as a Chrome trace file.
    profile_dir: str | None = None
    # An .npz path: per-chunk results, written after every chunk; a rerun with
    # the same configuration and inputs skips the chunks already done.
    checkpoint: str | None = None
    # Chunks in the pipeline: while one chunk solves, the next window - 1 are
    # meshed and their host arrays stacked on a background thread (the
    # "mesh_ahead" and "stack_ahead" phases). 1 = one chunk at a time, meshed
    # when its turn comes.
    pipeline_window: int = 3


class Executor:
    """Plans chunked dispatches for a list of :class:`BatchTask` and runs them."""

    def __init__(self, config: ExecutorConfig):
        self.timers = PhaseTimers()
        self.last_report = {"chunks": [], "n_failed_solves": 0, "n_nan_readouts": 0}
        if config.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype {config.dtype!r}: use 'float32' or 'float64'")
        if config.device is None:
            config = dataclasses.replace(config, device="cuda")
        self.device = torch.device(config.device)
        on_cuda = self.device.type == "cuda"
        if on_cuda and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {config.device!r}: no CUDA card is visible; pass "
                "device='cpu' to run on the CPU"
            )
        if on_cuda and self.device.index is None and distributed.is_multiprocess():
            # One card per process, PyTorch's idiom; ranks beyond the card
            # count share cards round robin.
            local = int(os.environ.get("LOCAL_RANK", distributed.world()[0]))
            self.device = torch.device("cuda", local % torch.cuda.device_count())
        self.mesher = None  # set by prepare_batches: "native", "numpy" or "device"
        auto = {}
        if config.preconditioner == "auto":
            auto["preconditioner"] = "multigrid" if on_cuda else "direct"
        if config.precond3d == "auto":
            auto["precond3d"] = "adi" if on_cuda else "direct"
        schedule = config.direct_schedule
        if schedule in ("auto", "scan") and config.direct_factor_passes is not None:
            schedule = "fp"  # the chain takes no pass count: a count means "fp"
        elif schedule == "auto":
            schedule = "bcr" if on_cuda else "scan"
        # The one place that resolves the schedule: the chunk solves switch on it alone.
        auto["direct_schedule"] = schedule
        if config.chunk_size is None:
            auto["chunk_size"] = 96 if on_cuda else 48
        if config.device_meshing is None:
            auto["device_meshing"] = on_cuda
        self.config = config = dataclasses.replace(config, **auto)
        for name, value, known in (
            ("preconditioner", config.preconditioner, ("multigrid", "local", "direct")),
            ("precond3d", config.precond3d, ("adi", "lines", "direct")),
            ("direct_schedule", config.direct_schedule, ("scan", "bcr", "fp")),
        ):
            if value not in known:
                raise ValueError(f"{name} {value!r}: use 'auto' or one of {known}")

    # ------------------------------------------------------------------- host side
    def prepare_batches(
        self,
        tasks: list[BatchTask],
        formation_parameters: np.ndarray,
        borehole_geometry: np.ndarray,
        mud_resistivities: np.ndarray,
        domain_radius: float,
        dip_rad: float,
        active_geometry_window: float,
    ) -> LazyGrids:
        """Per-batch grid builders, evaluated lazily (the "mesh" phase timer
        accounts every build, wherever it is triggered). A dip builds the 3D
        grid, else the 2D one (profiles only with device meshing); host grids
        are built natively under ``use_native_mesher`` (:attr:`mesher`)."""
        wants_native = self.config.use_native_mesher and (
            dip_rad != 0 or not self.config.device_meshing)
        native = wants_native and native_available()
        if wants_native and not native:
            _warn_numpy_fallback()
        if dip_rad != 0:
            builder = build_grid3d_native if native else build_grid3d
            self.mesher = "native" if native else "numpy"
        elif self.config.device_meshing:
            builder = build_grid2d_light
            self.mesher = "device"
        else:
            builder = build_grid2d_native if native else build_grid2d
            self.mesher = "native" if native else "numpy"

        def build_one(i: int):
            t = tasks[i]
            with self.timers.phase("mesh"):
                lm = carve_local_model(
                    formation_parameters,
                    borehole_geometry,
                    float(mud_resistivities[t.batch_index]),
                    t.center_depth,
                    domain_radius,
                    dip_rad=dip_rad,
                    active_geometry_window=active_geometry_window,
                )
                sources = np.unique(
                    np.concatenate([s.source_positions for s in t.solves])
                )
                if dip_rad != 0:
                    return builder(
                        self.config.spec3d, domain_radius, lm, dip_rad,
                        t.electrode_positions, sources,
                    )
                return builder(
                    self.config.spec, domain_radius, lm, t.electrode_positions, sources
                )

        return LazyGrids(len(tasks), build_one)

    def _direct_chunk_cap(self, base_chunk: int, grid_shape: tuple) -> int:
        """Batches per chunk that the direct factorization's memory allows.

        The factorization stores G: NZ blocks of (nodes per line or plane)^2
        per batch, in the solve's type. The chunk is capped so that G stays
        within a budget per schedule: the chain ("scan") the whole budget, "fp"
        half of it (two stacks alive at once), "bcr" 3.5/6 of it (about 1.5x
        the storage plus its products in flight); never below 2 batches. On
        the CPU the budgets are the JAX package's 6 / 3 / 3.5 GB, for 3D grids
        only (its 2D chunks are not capped; it reckons G at 4 bytes whatever
        the solve's type, the port at the type's size); on CUDA the chain's
        budget is an eighth of the card's memory, 2D and 3D. On an H100 the
        peak of allocated memory was 1.2-1.7x the chain's G, and 3.5x (3D) to
        5.9x (2D) the same G under "bcr" (PERF.md). Other preconditioners: no
        cap.
        """
        cfg = self.config
        is_3d = len(grid_shape) == 3
        on_cuda = self.device.type == "cuda"
        if (cfg.precond3d if is_3d else cfg.preconditioner) != "direct":
            return base_chunk
        if not (is_3d or on_cuda):
            return base_chunk
        budget = {"scan": 6e9, "fp": 3e9, "bcr": 3.5e9}[cfg.direct_schedule]
        if on_cuda:
            total = torch.cuda.get_device_properties(self.device).total_memory
            budget *= total / 8 / 6e9
        itemsize = np.dtype(cfg.dtype).itemsize
        g_bytes_per_batch = grid_shape[0] * int(np.prod(grid_shape[1:])) ** 2 * itemsize
        return max(2, min(base_chunk, int(budget // g_bytes_per_batch)))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _checkpoint_key(self, tasks, grids, n_measurements, n_tools, readout_factor, chunk,
                        n_ranks, grid_shape) -> str:
        """Key of a checkpoint: the run it belongs to. It hashes the solver
        configuration, the chunk partitioning (chunk offsets mean something only
        for the stride that made them), the world size and the model's content
        (every grid's coordinates and conductivities, or its profiles under device
        meshing, and the source and readout plan), so a rerun with another
        tolerance, world size or a same-shape edited formation recomputes."""
        cfg = self.config
        is_3d = len(grid_shape) == 3
        h = hashlib.blake2b(digest_size=16)
        cfg_sig = (
            cfg.tol, cfg.maxiter, cfg.dtype, cfg.preconditioner, cfg.precond3d,
            cfg.direct_schedule, cfg.direct_factor_passes, cfg.adi_damp, cfg.fail_residual,
            cfg.mg_degree, cfg.mg_power_iters, cfg.mg_line_steps, cfg.mg_smoother,
            cfg.metric3d, cfg.use_stencil_kernel, readout_factor, chunk, n_ranks,
            dataclasses.astuple(cfg.spec3d if is_3d else cfg.spec),
        )
        h.update(repr(cfg_sig).encode())
        for t, g in zip(tasks, grids):
            if isinstance(g, Grid2DLight):
                h.update(g.content_bytes())
            else:
                h.update(np.ascontiguousarray(g.coords).tobytes())
                h.update(np.ascontiguousarray(g.sigma_cells).tobytes())
            for s in t.solves:
                h.update(repr((
                    list(np.asarray(s.source_positions).ravel()),
                    list(np.asarray(s.source_terms).ravel()),
                    [(ro.measurement_index, ro.tool_index, ro.geometric_factor,
                      list(np.asarray(ro.measuring_positions).ravel())) for ro in s.readouts],
                )).encode())
        S = max(len(t.solves) for t in tasks)
        return f"{n_measurements}x{n_tools}|{len(tasks)}x{S}|{grid_shape}|{h.hexdigest()}"

    @contextlib.contextmanager
    def _profiled(self, rank: int):
        """A torch.profiler trace of the block into ``profile_dir`` (when set):
        CPU activities, and CUDA ones on a card; the file's path goes into
        ``last_report["profile_trace"]``."""
        if not self.config.profile_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(
            self.config.profile_dir,
            f"solve_rank{rank}_{os.getpid()}_{time.time_ns()}.pt.trace.json",
        )
        prof.export_chrome_trace(path)
        self.last_report["profile_trace"] = path

    def run(
        self,
        tasks: list[BatchTask],
        grids,
        n_measurements: int,
        n_tools: int,
        readout_factor: float = 1.0,
        verbose: bool = False,
    ) -> np.ndarray:
        """Execute all batches; returns results[measurement, tool] (NaN on failure).

        ``readout_factor`` is 0.5 for 3D half-space models (the half-ball
        carries the full current). With ``verbose`` a progress line is printed
        per chunk with CG iterations and the worst attained residual; chunk
        statistics are accumulated in ``self.last_report`` either way.

        Under several processes every rank calls this with the same arguments.
        Each chunk is split over the ranks: its batches evenly on the batch
        axis, or, when there are fewer batches than ranks, its solve slots on
        the solve axis too (:func:`_split_axes`). A rank meshes, stages, solves
        and reads out only its share; every rank returns the full results, and
        the failure counts of ``last_report`` are summed over the ranks (its
        per-chunk rows are this rank's).

        ``last_report["grids"]`` counts the grids this rank built in the run,
        all by ``last_report["mesher"]``; each chunk's row counts those of its
        own batches.
        """
        cfg = self.config
        dtype = np.dtype(cfg.dtype).type
        S = max(len(t.solves) for t in tasks)
        B_total = len(tasks)
        g0 = grids[0]
        is_3d = isinstance(g0, Grid3D)
        is_light = isinstance(g0, Grid2DLight)
        grid_shape = tuple(g0.grid_shape if is_light else g0.coords.shape[:-1])
        cell_shape = tuple(n - 1 for n in grid_shape)
        rank, n_ranks = distributed.world()
        n_batch_axis, n_solve_axis = _split_axes(n_ranks, B_total, S)
        # Bound concurrent solves (B*S): the chunk sizes are calibrated for the
        # default batch_size of 5. A chunk splits evenly over the batch axis.
        base = self._direct_chunk_cap(
            cfg.chunk_size_3d if is_3d else cfg.chunk_size, grid_shape)
        chunk = max(1, min(base, max(1, base * 5 // S), B_total), n_batch_axis)
        chunk = -(-chunk // n_batch_axis) * n_batch_axis
        lanes, slots = chunk // n_batch_axis, S // n_solve_axis
        b_coord, s_coord = divmod(rank, n_solve_axis)
        lane0, slot0 = b_coord * lanes, s_coord * slots

        results = np.full((n_measurements, n_tools), np.nan)
        owned = np.zeros(results.shape, dtype=bool)  # the readouts this rank made
        self.last_report = {
            "chunks": [], "n_failed_solves": 0, "n_nan_readouts": 0,
            "chunk": chunk, "n_solve_slots": S, "factor_seconds": 0.0,
            "preconditioner": cfg.precond3d if is_3d else cfg.preconditioner,
            "direct_schedule": cfg.direct_schedule,
            "use_stencil_kernel": cfg.use_stencil_kernel,
            "device": str(self.device),
            "mesher": self.mesher,
            "world_size": n_ranks,
            "axes": {"batch": n_batch_axis, "solve": n_solve_axis},
        }
        # Layer-table pad: one tensor shape per run, sized to the deepest carved
        # stack and bucketed (multiples of 16, floor 48).
        if is_light:
            lmax = max(g.bottoms.size for g in grids)
            LMAX_LAYERS = max(48, -(-lmax // 16) * 16)

        ckpt_key = None
        done_chunks: set[int] = set()
        if cfg.checkpoint:
            ckpt_key = self._checkpoint_key(tasks, grids, n_measurements, n_tools,
                                            readout_factor, chunk, n_ranks, grid_shape)
            if os.path.exists(cfg.checkpoint):
                saved = np.load(cfg.checkpoint, allow_pickle=False)
                if str(saved["key"]) == ckpt_key:
                    results = saved["results"]
                    done_chunks = {int(c) for c in saved["done_chunks"]}
                    if verbose and done_chunks:
                        print(f"  resuming: {len(done_chunks)} chunks already done")
        self.last_report["resumed_chunks"] = len(done_chunks)

        built = getattr(grids, "built", set())

        def lanes_of(start):
            """The batch indices of this rank's share of the chunk at ``start``."""
            return range(min(start + lane0, B_total), min(start + lane0 + lanes, B_total))

        def share(start):
            """This rank's batch tasks and grids of the chunk at ``start``, and
            the grid its padded lanes copy (the chunk's first)."""
            idx = lanes_of(start)
            return tasks[idx.start:idx.stop], grids[idx.start:idx.stop], grids[start]

        def stage_sources(batch_tasks, batch_grids, B):
            src_i = np.zeros((B, slots, MAX_SOURCES), dtype=np.int64)
            src_fac = np.zeros((B, slots, MAX_SOURCES), dtype=dtype)
            for bi, (t, g) in enumerate(zip(batch_tasks, batch_grids)):
                for si, s in enumerate(t.solves[slot0 : slot0 + slots]):
                    for k, (pos, fac) in enumerate(zip(s.source_positions, s.source_terms)):
                        src_i[bi, si, k] = g.axis_node_index(pos)
                        src_fac[bi, si, k] = fac
            return [src_i, src_fac]

        def host_light(batch_tasks, batch_grids, pad):
            """Device-meshing staging: ~KB of 1D profiles per batch, meshed on
            the device by :func:`place`."""
            B = lanes
            nz = grid_shape[0]
            nfar = pad.far.size
            z = np.zeros((B, nz), dtype=dtype)
            wall = np.zeros((B, nz), dtype=dtype)
            far = np.zeros((B, nfar), dtype=dtype)
            rdet = np.zeros((B,), dtype=dtype)
            bot = np.full((B, LMAX_LAYERS), np.inf, dtype=dtype)
            fzr = np.full((B, LMAX_LAYERS), np.nan, dtype=dtype)
            sfz = np.full((B, LMAX_LAYERS), np.nan, dtype=dtype)
            suz = np.ones((B, LMAX_LAYERS), dtype=dtype)
            nlay = np.ones((B,), dtype=np.int64)
            mud = np.ones((B,), dtype=dtype)
            for bi, g in enumerate(batch_grids):
                L = g.bottoms.size
                z[bi] = g.z_axis
                wall[bi] = g.wall_of_z
                far[bi] = g.far
                rdet[bi] = g.r_detach
                bot[bi, :L] = g.bottoms
                fzr[bi, :L] = g.fz_radius
                sfz[bi, :L] = g.sigma_fz
                suz[bi, :L] = g.sigma_uz
                nlay[bi] = L
                mud[bi] = g.mud_sigma
            for bi in range(len(batch_grids), B):  # padded lanes: unit medium
                z[bi] = pad.z_axis
                wall[bi] = pad.wall_of_z
                far[bi] = pad.far
                rdet[bi] = pad.r_detach
            return [z, wall, far, rdet, bot, fzr, sfz, suz, nlay, mud,
                    *stage_sources(batch_tasks, batch_grids, B)]

        def host_arrays(start):
            """The host half of staging: this rank's share of one chunk, its
            grids built if they were not (the "mesh" phase), stacked into
            numpy arrays (the "stack" phase). No device work, so it may run on
            the pipeline's thread."""
            batch_tasks, batch_grids, pad = share(start)
            with self.timers.phase("stack"):
                if is_light:
                    return host_light(batch_tasks, batch_grids, pad)
                B = lanes  # pad to a full share: one tensor shape for every dispatch
                coords = np.zeros((B,) + g0.coords.shape, dtype=dtype)
                sigma = np.zeros((B,) + cell_shape, dtype=dtype)
                free = np.zeros((B,) + tuple(grid_shape), dtype=bool)
                for bi, g in enumerate(batch_grids):
                    coords[bi] = g.coords
                    sigma[bi] = g.sigma_cells
                    free[bi] = g.free_mask
                # Keep padded lanes numerically benign: real coords, sigma 1.
                for bi in range(len(batch_tasks), B):
                    coords[bi] = pad.coords
                    sigma[bi] = 1.0
                    free[bi] = pad.free_mask
                return [coords, sigma, free, *stage_sources(batch_tasks, batch_grids, B)]

        def host_arrays_ahead(start, context):
            """:func:`host_arrays` on the pipeline's thread, its phases timed
            as "mesh_ahead" and "stack_ahead" (they overlap the solve) and
            recorded as spans of the submitting request, ``context``."""
            with entered(context), self.timers.suffixed("_ahead"):
                return host_arrays(start)

        def place(arrays):
            """The device half of staging (the "stage" phase): the arrays on
            the device, meshed there under device meshing."""
            out = [self._tensor(a) for a in arrays]
            if not is_light:
                return out
            spec = cfg.spec
            coords, sigma, free = device_mesh_2d(
                *out[:-2],
                float(dtype(g0.domain_radius)),
                nz=spec.nz,
                nr=spec.nr,
                n_wall_cells=spec.n_wall_cells,
                n_blend_cells=spec.n_blend_cells,
                blend_m0=spec.blend_m0,
            )
            return [coords, sigma, free, *out[-2:]]

        def solve(args):
            timings = {}
            if is_3d:
                out = _solve_chunk_3d(
                    *args,
                    tol=cfg.tol,
                    maxiter=cfg.maxiter,
                    precond=cfg.precond3d,
                    adi_damp=cfg.adi_damp,
                    use_kernel=cfg.use_stencil_kernel,
                    schedule=cfg.direct_schedule,
                    factor_passes=cfg.direct_factor_passes,
                    metric=cfg.metric3d,
                    timings=timings,
                )
            elif cfg.preconditioner == "direct":
                out = _solve_chunk_direct(
                    *args,
                    tol=cfg.tol,
                    maxiter=cfg.maxiter,
                    use_kernel=cfg.use_stencil_kernel,
                    schedule=cfg.direct_schedule,
                    factor_passes=cfg.direct_factor_passes,
                    timings=timings,
                )
            else:
                out = _solve_chunk(
                    *args,
                    tol=cfg.tol,
                    maxiter=cfg.maxiter,
                    preconditioner=cfg.preconditioner,
                    use_kernel=cfg.use_stencil_kernel,
                    mg_degree=cfg.mg_degree,
                    mg_power_iters=cfg.mg_power_iters,
                    mg_line_steps=cfg.mg_line_steps,
                    mg_smoother=cfg.mg_smoother,
                    timings=timings,
                )
            u_axis, rel_res, iters = out
            with self.timers.phase("results_wait"):
                host = u_axis.cpu().numpy(), rel_res.cpu().numpy(), iters
            if "factor" in timings:  # read behind the copies: the device has passed it
                self.last_report["factor_seconds"] += timings["factor"]()
            return host, timings["graph"]

        # The pipeline: while a chunk solves, the next window - 1 chunks are
        # meshed and stacked on one background thread (the native mesher's
        # ctypes calls and the host's waits on the device release the GIL);
        # the first chunk is meshed and stacked here, before the pipeline
        # starts. The device work (copies, device meshing, the solve, all on
        # the solve stream) stays in order on this thread, so the chunks, their
        # arithmetic and the checkpoints are those of a window of 1.
        window = max(1, int(cfg.pipeline_window))
        todo = [s for s in range(0, B_total, chunk) if s not in done_chunks]
        pending: dict = {}  # chunk start -> future of its host arrays
        n_failed_total = n_nan_total = 0
        with contextlib.ExitStack() as stack:
            stack.enter_context(self._profiled(rank))
            stack.enter_context(solve_stream(self.device))
            ahead = None
            if window > 1 and len(todo) > 1:
                ahead = ThreadPoolExecutor(1, "remo3d-pipeline")
                stack.callback(ahead.shutdown, wait=True, cancel_futures=True)
            for i, start in enumerate(todo):
                if start in pending:  # what the pipeline did not hide
                    with self.timers.phase("pipeline_wait"):
                        arrays = pending.pop(start).result()
                else:
                    arrays = host_arrays(start)
                if ahead is not None:
                    for nxt in todo[i + 1 : i + window]:
                        if nxt not in pending:
                            pending[nxt] = ahead.submit(host_arrays_ahead, nxt,
                                                        request_context())
                batch_tasks, batch_grids, _ = share(start)
                with self.timers.phase("stage"):
                    args = place(arrays)
                del arrays
                fused = pcr_lines.FUSED.LAUNCHES
                with self.timers.phase("solve", label="remo3d_tpu_torch.solve_chunk"):
                    (u_axis, rel_res, iters), graph = solve(args)
                fused = pcr_lines.FUSED.LAUNCHES - fused
                del args
                n_failed = 0
                n_nan = 0
                with self.timers.phase("readout"):
                    for bi, (t, g) in enumerate(zip(batch_tasks, batch_grids)):
                        for si, s in enumerate(t.solves[slot0 : slot0 + slots]):
                            failed = (
                                not np.isfinite(rel_res[bi, si])
                                or rel_res[bi, si] > cfg.fail_residual
                            )
                            n_failed += failed
                            for ro in s.readouts:
                                if failed:
                                    value = np.nan
                                    n_nan += 1
                                else:
                                    pots = [
                                        u_axis[bi, si, g.axis_node_index(p)]
                                        for p in ro.measuring_positions
                                    ]
                                    if len(pots) == 2:
                                        value = abs(ro.geometric_factor * (pots[1] - pots[0]))
                                    else:
                                        value = abs(ro.geometric_factor * pots[0])
                                    value *= readout_factor
                                results[ro.measurement_index, ro.tool_index] = value
                                owned[ro.measurement_index, ro.tool_index] = True

                n_real = sum(len(t.solves[slot0 : slot0 + slots]) for t in batch_tasks)
                worst = float(np.max(rel_res[: len(batch_tasks)])) if batch_tasks else 0.0
                self.last_report["chunks"].append(
                    {
                        "batches": len(batch_tasks),
                        "solves": n_real,
                        "iterations": iters,
                        "worst_residual": worst,
                        "failed_solves": n_failed,
                        "grids": sum(b in built for b in lanes_of(start)),
                        "k3_fused": fused,
                        **graph,
                    }
                )
                n_failed_total += n_failed
                n_nan_total += n_nan
                if verbose:
                    done = min(start + chunk, B_total)
                    msg = (
                        f"\r  [{done}/{B_total}] batches solved"
                        f" (CG iters {iters}, worst rel residual {worst:.1e}"
                    )
                    if n_failed:
                        msg += f", {n_failed} FAILED solves -> NaN"
                    print(msg + ")", end="", flush=True)

                if cfg.checkpoint:
                    done_chunks.add(start)
                    results = distributed.gather_result(results, owned)
                    if rank == 0:
                        tmp = cfg.checkpoint + ".tmp.npz"
                        np.savez(
                            tmp,
                            key=ckpt_key,
                            results=results,
                            done_chunks=np.array(sorted(done_chunks), dtype=np.int64),
                        )
                        os.replace(tmp, cfg.checkpoint)
        if verbose:
            print()
        results = distributed.gather_result(results, owned)
        self.last_report["grids"] = len(built)
        self.last_report["n_failed_solves"], self.last_report["n_nan_readouts"] = (
            distributed.sum_over_ranks([n_failed_total, n_nan_total]))
        return results
