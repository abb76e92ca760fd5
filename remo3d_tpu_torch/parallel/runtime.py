# -*- coding: utf-8 -*-
"""Batched solve executor on one torch device (a CUDA card or the CPU).

Counterpart of ``remo3d_tpu.parallel.runtime`` for the 2D axisymmetric path.
All batch meshes of a chunk are stacked into fixed-shape tensors and solved
together (assembly + batched multigrid PCG + axis readout); solves are uniform in
cost by construction (fixed topology), so chunks are padded with benign lanes
instead of being scheduled dynamically.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..meshing.carve import carve_local_model
from ..meshing.device_mesh import device_mesh_2d
from ..meshing.grid2d import Grid2DLight, GridSpec2D, build_grid2d, build_grid2d_light
from ..ops.assembly2d import (
    apply_dirichlet,
    element_matrices_2d,
    fold_to_stencil,
    fundamental_potential_2d,
    singularity_rhs_2d,
)
from ..ops.cg import pcg
from ..ops.multigrid import MGConfig, make_mg_preconditioner, make_stencil_apply
from ..ops.stencil import stencil_apply
from ..planner import BatchTask
from ..utils.timers import PhaseTimers

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
    mg_line_steps=None, mg_smoother="line_rz",
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
    """
    nz, nr = coords.shape[-3], coords.shape[-2]
    freeb = free[:, None]  # broadcast over the solve axis

    # Assemble once; keep the raw stencil for the boundary-lift product and derive
    # the eliminated system + MG hierarchy from it.
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

    if subtract:
        sigma0 = sigma[:, 0, 0]  # borehole column = mud conductivity
        z_axis = coords[:, :, 0, 0]  # (B, NZ)
        B, S = src_i.shape[:2]
        src_z = torch.gather(z_axis[:, None, :].expand(B, S, nz), 2, src_i)  # (B,S,2)
        u_s = fundamental_potential_2d(coords, sigma0, src_z, src_fac)
        rhs = singularity_rhs_2d(coords, sigma, sigma0, src_z, src_fac)
        g_lift = torch.where(freeb, torch.zeros_like(u_s), -u_s)
        # The lift uses the RAW stencil: the eliminated one has no couplings
        # into the Dirichlet nodes.
        rhs = rhs - stencil_apply(C_raw, g_lift)
        rhs = torch.where(freeb, rhs, torch.zeros_like(rhs))
        w0, info = pcg(C, rhs, M_inv=M_inv, tol=tol, maxiter=maxiter, matvec=matvec)
        u = w0 + g_lift + u_s
    else:
        b = torch.zeros(tuple(src_i.shape[:2]) + (nz, nr), dtype=coords.dtype,
                        device=coords.device)
        for k in range(src_i.shape[-1]):
            b[..., 0].scatter_add_(-1, src_i[..., k : k + 1], src_fac[..., k : k + 1])
        u, info = pcg(C, b, M_inv=M_inv, tol=tol, maxiter=maxiter, matvec=matvec)
    # Axis potentials are all the readout needs (electrodes sit on axis nodes).
    return u[..., 0], info["rel_residual"], info["iterations"]


class LazyGrids:
    """Sequence of per-batch grids, built on first access and cached.

    Supports int and slice indexing and iteration, so eager-list call sites work
    unchanged, and :meth:`ensure` builds a range ahead of use.
    """

    def __init__(self, n: int, build_one):
        self._build = build_one
        self._cache: list = [None] * n

    def __len__(self) -> int:
        return len(self._cache)

    def ensure(self, start: int = 0, stop: int | None = None) -> None:
        stop = len(self._cache) if stop is None else min(stop, len(self._cache))
        for i in range(max(start, 0), stop):
            if self._cache[i] is None:
                self._cache[i] = self._build(i)

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
    tol: float = 1e-7
    maxiter: int = 1000
    dtype: str = "float32"
    # Torch device: "cuda", "cuda:N" or "cpu". None = "cuda" when a card is
    # visible, else "cpu".
    device: str | None = None
    # Batch meshes per chunk. None = auto: 96 on CUDA (a starting value, to be
    # re-screened on the card), 48 on the CPU.
    chunk_size: int | None = None
    # "auto" (-> "multigrid" on every device), "multigrid", or "local" (point
    # Jacobi). "direct" (block-direct solver) is ROADMAP slice 3.
    preconditioner: str = "auto"
    # Route the CG matvec and the two finest MG levels through the half-storage
    # stencil wrapper: the CUDA kernel on CUDA tensors, its plain version on CPU
    # tensors. False = the full 9-point plain apply everywhere.
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
    # Build the 2D grids on the device from 1D profiles (meshing/device_mesh.py)
    # instead of staging host-built arrays. None = auto: on for CUDA, off on CPU.
    device_meshing: bool | None = None
    # Chunks staged and solved ahead of the readout point.
    pipeline_window: int = 3


class Executor:
    """Plans chunked dispatches for a list of :class:`BatchTask` and runs them."""

    def __init__(self, config: ExecutorConfig):
        self.timers = PhaseTimers()
        self.last_report = {"chunks": [], "n_failed_solves": 0, "n_nan_readouts": 0}
        if config.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype {config.dtype!r}: use 'float32' or 'float64'")
        if config.device is None:
            config = dataclasses.replace(
                config, device="cuda" if torch.cuda.is_available() else "cpu"
            )
        self.device = torch.device(config.device)
        on_cuda = self.device.type == "cuda"
        auto = {}
        if config.preconditioner == "auto":
            auto["preconditioner"] = "multigrid"
        if config.chunk_size is None:
            auto["chunk_size"] = 96 if on_cuda else 48
        if config.device_meshing is None:
            auto["device_meshing"] = on_cuda
        self.config = config = dataclasses.replace(config, **auto)
        if config.preconditioner not in ("multigrid", "local"):
            raise NotImplementedError(
                f"preconditioner {config.preconditioner!r}: the port has "
                "'multigrid' and 'local'; the block-direct solver is ROADMAP slice 3"
            )

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
        accounts every build, wherever it is triggered)."""
        if dip_rad != 0:
            raise NotImplementedError(
                "dip != 0 (the 3D dipping-layer solver) is ROADMAP slice 2"
            )

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
                builder = build_grid2d_light if self.config.device_meshing else build_grid2d
                return builder(
                    self.config.spec, domain_radius, lm, t.electrode_positions, sources
                )

        return LazyGrids(len(tasks), build_one)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def run(
        self,
        tasks: list[BatchTask],
        grids,
        n_measurements: int,
        n_tools: int,
        verbose: bool = False,
    ) -> np.ndarray:
        """Execute all batches; returns results[measurement, tool] (NaN on failure).

        With ``verbose`` a progress line is printed per chunk with CG iteration
        counts and the worst attained residual; chunk statistics are accumulated
        in ``self.last_report`` either way.
        """
        cfg = self.config
        dtype = np.dtype(cfg.dtype).type
        S = max(len(t.solves) for t in tasks)
        B_total = len(tasks)
        # Bound concurrent solves (B*S): chunk_size is calibrated for the
        # default batch_size of 5.
        chunk = max(1, min(cfg.chunk_size, max(1, cfg.chunk_size * 5 // S), B_total))

        results = np.full((n_measurements, n_tools), np.nan)
        g0 = grids[0]
        is_light = isinstance(g0, Grid2DLight)
        grid_shape = g0.grid_shape if is_light else g0.coords.shape[:-1]
        cell_shape = tuple(n - 1 for n in grid_shape)
        self.last_report = {
            "chunks": [], "n_failed_solves": 0, "n_nan_readouts": 0,
            "chunk": chunk, "n_solve_slots": S,
            "use_stencil_kernel": cfg.use_stencil_kernel,
            "device": str(self.device),
        }
        # Layer-table pad: one tensor shape per run, sized to the deepest carved
        # stack and bucketed (multiples of 16, floor 48).
        if is_light:
            lmax = max(g.bottoms.size for g in grids)
            LMAX_LAYERS = max(48, -(-lmax // 16) * 16)

        def stage_sources(batch_tasks, batch_grids, B):
            src_i = np.zeros((B, S, MAX_SOURCES), dtype=np.int64)
            src_fac = np.zeros((B, S, MAX_SOURCES), dtype=dtype)
            for bi, (t, g) in enumerate(zip(batch_tasks, batch_grids)):
                for si, s in enumerate(t.solves):
                    for k, (pos, fac) in enumerate(zip(s.source_positions, s.source_terms)):
                        src_i[bi, si, k] = g.axis_node_index(pos)
                        src_fac[bi, si, k] = fac
            return self._tensor(src_i), self._tensor(src_fac)

        def stage_light(start):
            """Device-meshing staging: ~KB of 1D profiles per batch, meshed on
            the device."""
            batch_tasks = tasks[start : start + chunk]
            batch_grids = grids[start : start + chunk]
            B = chunk
            nz = grid_shape[0]
            nfar = batch_grids[0].far.size
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
                z[bi] = batch_grids[0].z_axis
                wall[bi] = batch_grids[0].wall_of_z
                far[bi] = batch_grids[0].far
                rdet[bi] = batch_grids[0].r_detach
            profiles = [self._tensor(a) for a in (z, wall, far, rdet, bot, fzr, sfz, suz, nlay, mud)]
            spec = cfg.spec
            coords, sigma, free = device_mesh_2d(
                *profiles,
                float(dtype(g0.domain_radius)),
                nz=spec.nz,
                nr=spec.nr,
                n_wall_cells=spec.n_wall_cells,
                n_blend_cells=spec.n_blend_cells,
                blend_m0=spec.blend_m0,
            )
            return [coords, sigma, free, *stage_sources(batch_tasks, batch_grids, B)]

        def stage(start):
            """Stack one chunk's host-built arrays and place them on the device."""
            if is_light:
                return stage_light(start)
            batch_tasks = tasks[start : start + chunk]
            batch_grids = grids[start : start + chunk]
            B = chunk  # pad to a full chunk: one tensor shape for every dispatch
            coords = np.zeros((B,) + g0.coords.shape, dtype=dtype)
            sigma = np.zeros((B,) + cell_shape, dtype=dtype)
            free = np.zeros((B,) + tuple(grid_shape), dtype=bool)
            for bi, g in enumerate(batch_grids):
                coords[bi] = g.coords
                sigma[bi] = g.sigma_cells
                free[bi] = g.free_mask
            # Keep padded lanes numerically benign: real coords, sigma 1.
            for bi in range(len(batch_tasks), B):
                coords[bi] = batch_grids[0].coords
                sigma[bi] = 1.0
                free[bi] = batch_grids[0].free_mask
            return [self._tensor(coords), self._tensor(sigma), self._tensor(free),
                    *stage_sources(batch_tasks, batch_grids, B)]

        def solve(args):
            u_axis, rel_res, iters = _solve_chunk(
                *args,
                tol=cfg.tol,
                maxiter=cfg.maxiter,
                preconditioner=cfg.preconditioner,
                use_kernel=cfg.use_stencil_kernel,
                mg_degree=cfg.mg_degree,
                mg_power_iters=cfg.mg_power_iters,
                mg_line_steps=cfg.mg_line_steps,
                mg_smoother=cfg.mg_smoother,
            )
            return u_axis.cpu().numpy(), rel_res.cpu().numpy(), iters

        # Chunks are meshed, staged and solved up to ``window`` ahead of the
        # readout point. The CG loop syncs with the device every iteration, so
        # the solve is not overlapped with host work yet (ROADMAP).
        window = max(1, int(cfg.pipeline_window))
        todo = list(range(0, B_total, chunk))
        inflight: list[tuple[int, tuple]] = []
        next_i = 0

        def fill_pipeline():
            nonlocal next_i
            while next_i < len(todo) and len(inflight) < window:
                s0 = todo[next_i]
                next_i += 1
                if hasattr(grids, "ensure"):  # mesh before staging: phases stay additive
                    grids.ensure(s0, s0 + chunk)
                with self.timers.phase("stage"):
                    args = stage(s0)
                with self.timers.phase("solve"):
                    inflight.append((s0, solve(args)))

        fill_pipeline()
        while inflight:
            start, (u_axis, rel_res, iters) = inflight.pop(0)
            fill_pipeline()
            batch_tasks = tasks[start : start + chunk]
            batch_grids = grids[start : start + chunk]
            n_failed = 0
            n_nan = 0
            with self.timers.phase("readout"):
                for bi, (t, g) in enumerate(zip(batch_tasks, batch_grids)):
                    for si, s in enumerate(t.solves):
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
                            results[ro.measurement_index, ro.tool_index] = value

            n_real = sum(len(t.solves) for t in batch_tasks)
            worst = float(np.max(rel_res[: len(batch_tasks)])) if batch_tasks else 0.0
            self.last_report["chunks"].append(
                {
                    "batches": len(batch_tasks),
                    "solves": n_real,
                    "iterations": iters,
                    "worst_residual": worst,
                    "failed_solves": n_failed,
                }
            )
            self.last_report["n_failed_solves"] += n_failed
            self.last_report["n_nan_readouts"] += n_nan
            if verbose:
                done = min(start + chunk, B_total)
                msg = (
                    f"\r  [{done}/{B_total}] batches solved"
                    f" (CG iters {iters}, worst rel residual {worst:.1e}"
                )
                if n_failed:
                    msg += f", {n_failed} FAILED solves -> NaN"
                print(msg + ")", end="", flush=True)
        if verbose:
            print()
        return results
