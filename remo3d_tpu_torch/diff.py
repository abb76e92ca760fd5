# -*- coding: utf-8 -*-
"""Differentiable forward modeling: logs as a torch function of resistivity.

Port of ``remo3d_tpu.diff``. ``DifferentiableLog(model, depths)`` captures the
planning and meshing of a configured :class:`~remo3d_tpu_torch.model.Model`
(the geometry is frozen; the per-cell conductivity becomes a gather from the
parameter vector), and calling it with a resistivity tensor returns the
(n_measurements, n_tools) log matrix as a differentiable torch function:

* reverse mode (``torch.autograd.grad`` of any scalar of the log) costs one
  extra linear solve per chunk: the solve is
  :func:`~remo3d_tpu_torch.ops.linear_solve.linear_solve`, whose backward is
  the adjoint solve on the same factorization; autograd records the assembly,
  never the factorization or the CG loop;
* :meth:`DifferentiableLog.jacobian` (forward mode) costs P extra right-hand
  sides per chunk sharing the chunk's factorization
  (:func:`~remo3d_tpu_torch.ops.linear_solve.solve_tangents`), not P
  simulations.

The stencil applies go through K1 and K2 (``kernels/``) on a CUDA device, each
a ``torch.autograd.Function`` with its reverse and forward derivative. The
factorization is the block-direct preconditioner of the production path,
built from the detached operator under ``torch.no_grad()``: "scan" on the CPU,
as in the JAX package, "bcr" on CUDA (the port's resolution of an explicit
"direct"), "fp" with ``factor_passes``. The preconditioner carries no
gradient, so the schedule changes only the CG iteration count.

The JAX package's ``lax.map`` over chunks is a Python loop, and its cached
``jax.jit`` of the forward and of ``jax.jacfwd`` are eager calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

from .convert import chunk_plan_to_torch
from .kernels.stencil2d import half_planes_2d
from .kernels.stencil3d import half_planes_3d
from .meshing.carve import carve_local_model
from .meshing.grid2d import GridSpec2D, build_grid2d
from .meshing.grid3d import GridSpec3D, build_grid3d
from .ops.assembly2d import apply_dirichlet, element_matrices_2d, fold_to_stencil
from .ops.block_direct import highest_matmul_precision
from .ops.linear_solve import linear_solve, solve_tangents
from .ops.stencil3d import pole_project
from .parallel.runtime import (
    ExecutorConfig,
    _apply3,
    _assemble3,
    _build_rhs2_subtract,
    _build_rhs3_subtract,
    _factor2_direct,
    _factor3_direct,
    _timed,
)
from .planner import plan_tasks
from .utils.timers import PhaseTimers, span

MAX_SOURCES = 4


@dataclasses.dataclass
class _ChunkPlan:
    """Static staging arrays for one device chunk (see DifferentiableLog)."""

    coords: np.ndarray  # (B, NZ, NR, 2)
    free: np.ndarray  # (B, NZ, NR) bool
    region: np.ndarray  # (B, NZ-1, NR-1) int32 param index, -1 = fixed (mud/pad)
    sigma_fixed: np.ndarray  # (B, NZ-1, NR-1) conductivity where region == -1
    src_i: np.ndarray  # (B, S, MAX_SOURCES) int32
    src_fac: np.ndarray  # (B, S, MAX_SOURCES)
    ro_b: np.ndarray  # (RO,) int32 batch lane of each readout
    ro_s: np.ndarray  # (RO,) int32 solve lane
    ro_i0: np.ndarray  # (RO,) int32 axis node of the first measuring electrode
    ro_i1: np.ndarray  # (RO,) int32 second electrode node, NZ = "zero potential"
    ro_k: np.ndarray  # (RO,) geometric factors
    ro_out: np.ndarray  # (RO, 2) int32 (measurement, tool); row0 = n_meas -> dropped


@dataclasses.dataclass
class _ChunkPlan3D:
    """Static staging arrays for one 3D device chunk.

    Per-cell sigma is rebuilt in each call as ``fixed ? sigma_fixed :
    (fz_cell >= 0 ? params[fz_cell] : weights @ params[uz_map])``; the weight
    rows are the 3D grid's arithmetic sub-cell homogenization
    (grid3d.py:_zeta_overlap_weights).
    """

    coords: np.ndarray  # (B, NZ, NP, NR, 3)
    free: np.ndarray  # (B, NZ, NP, NR) bool
    weights: np.ndarray  # (B, NZ-1, NP-1, NR-1, Lmax) local-layer weights
    uz_map: np.ndarray  # (B, Lmax) int32 global param of each local layer's UZ
    fz_cell: np.ndarray  # (B, NZ-1, NP-1, NR-1) int32 global FZ param, -1 = none
    fixed: np.ndarray  # (B, NZ-1, NP-1, NR-1) bool mud column / padding
    sigma_fixed: np.ndarray  # conductivity where fixed
    src_i: np.ndarray  # (B, S, MAX_SOURCES) int32
    src_fac: np.ndarray  # (B, S, MAX_SOURCES)
    ro_b: np.ndarray
    ro_s: np.ndarray
    ro_i0: np.ndarray
    ro_i1: np.ndarray
    ro_k: np.ndarray  # geometric factors (pre-multiplied by the 3D 0.5)
    ro_out: np.ndarray


class DifferentiableLog:
    """Logs of a fixed geometry as a differentiable torch function of layer
    resistivities.

    Parameters are the formation table's resistivity VALUES in table order:
    first every layer's UZ (undisturbed) resistivity, then the FZ (invaded)
    resistivity of each layer that has an invasion zone (:attr:`param_names`,
    :attr:`params0`). Layer boundaries, invasion radii, the borehole and the
    mud resistivity are frozen at construction: they shape the grid.

    ``device``: a torch device string; None means "cuda" and raises when no
    card is visible (pass "cpu" for a CPU run). The other arguments are the
    JAX package's; the solve runs in float32, as there. The factorization's
    schedule (:attr:`direct_schedule`) is "bcr" on CUDA and "scan" on the
    CPU, or "fp" with ``factor_passes`` passes.

    >>> dlog = DifferentiableLog(model, depths, device="cpu")
    >>> logs = dlog.forward(dlog.params0)              # (n_meas, n_tools)
    >>> J = dlog.jacobian(dlog.params0)                # (n_meas, n_tools, P)
    >>> p = torch.tensor(dlog.params0, requires_grad=True)
    >>> g, = torch.autograd.grad(loss(dlog(p)), p)      # one adjoint pass
    """

    def __init__(
        self,
        model,
        measurement_depths,
        *,
        domain_radius: float = 50.0,
        batch_size: int = 5,
        grid_spec: GridSpec2D | None = None,
        grid_spec3d: GridSpec3D | None = None,
        tol: float = 3e-7,
        maxiter: int = 1000,
        chunk_size: int = 8,
        factor_passes: int | None = None,
        active_window: float = 0.999,
        metric3d: str | None = None,
        device: str | None = None,
    ):
        if (
            model.formation_model is None
            or model.borehole_model is None
            or model.dip_deg is None
        ):
            raise ValueError("call model.set_model_parameters first")
        self.device = torch.device("cuda" if device is None else device)
        on_cuda = self.device.type == "cuda"
        if on_cuda and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(self.device)!r}: no CUDA card is visible; pass "
                "device='cpu' to run on the CPU"
            )
        # The factorization's schedule, as the runtime resolves an explicit
        # "direct": a pass count means "fp", else "bcr" on CUDA, "scan" on the CPU.
        if factor_passes is not None:
            schedule = "fp"
        else:
            schedule = "bcr" if on_cuda else "scan"
        self.direct_schedule = schedule
        self._is3d = not np.isclose(model.dip_deg, 0)
        dip_rad = float(np.deg2rad(model.dip_deg))
        if self._is3d:
            spec3 = grid_spec3d or GridSpec3D()
        else:
            spec = grid_spec or GridSpec2D()
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self.factor_passes = factor_passes
        # Follow the live executor's 3D assembly metric (it may carry an
        # executor_overrides={'metric3d': ...}), else the config default, so
        # that forward parity with Model.simulate_logs holds.
        if metric3d is None:
            executor = getattr(model, "_executor", None)
            metric3d = (executor.config if executor is not None else ExecutorConfig).metric3d
        self.metric3d = metric3d
        self.n_tools = len(model.tools)

        measurement_depths = np.asarray(measurement_depths, dtype=float)
        self.n_measurements = measurement_depths.size
        simulation_depths, tasks = plan_tasks(
            model.tools, model.sec, measurement_depths, batch_size
        )
        mud_resistivities = np.interp(
            simulation_depths,
            model.borehole_model[:, 0],
            model.borehole_model[:, 2],
        )

        # ---- Parameter layout over the GLOBAL formation table ----------------
        fm = model.formation_model  # (L, 5): top, bottom, fz_radius, fz_rho, uz_rho
        L = fm.shape[0]
        has_fz = ~np.isnan(fm[:, 2])
        fz_param_of_row = np.full(L, -1, dtype=np.int32)
        fz_param_of_row[has_fz] = L + np.arange(int(has_fz.sum()), dtype=np.int32)
        self.param_names = [f"UZ[{l}]" for l in range(L)] + [
            f"FZ[{l}]" for l in np.flatnonzero(has_fz)
        ]
        self.params0 = np.concatenate([fm[:, 4], fm[has_fz, 3]])

        # ---- Host staging: grids with region provenance ----------------------
        S = max(len(t.solves) for t in tasks)
        chunk = max(1, int(chunk_size))
        plans: list = []
        grids = []
        for t in tasks:
            lm = carve_local_model(
                model.formation_model,
                model.borehole_model[:, :2],
                float(mud_resistivities[t.batch_index]),
                t.center_depth,
                domain_radius,
                dip_rad=dip_rad,
                active_geometry_window=active_window,
            )
            sources = np.unique(np.concatenate([s.source_positions for s in t.solves]))
            # local layer -> global param: promoted layers' "UZ" value IS the
            # global row's FZ parameter (carve.py invasion-zone promotion).
            rows = lm.global_rows
            uz_map = np.where(lm.fz_promoted, fz_param_of_row[rows], rows).astype(np.int32)
            fz_map = fz_param_of_row[rows]
            if self._is3d:
                g = build_grid3d(
                    spec3, domain_radius, lm, dip_rad,
                    t.electrode_positions, sources, with_regions=True,
                )
                lay = g.region_fz_layer
                fz_cell = np.where(
                    lay >= 0, fz_map[np.clip(lay, 0, None)], np.int32(-1)
                ).astype(np.int32)
                grids.append((g, (uz_map, fz_cell)))
                continue
            g = build_grid2d(spec, domain_radius, lm, t.electrode_positions, sources)
            lay = g.region_layer
            region = np.where(
                lay < 0,
                np.int32(-1),
                np.where(g.region_invaded, fz_map[lay], uz_map[lay]),
            ).astype(np.int32)
            grids.append((g, region))

        nz = spec3.nz if self._is3d else spec.nz
        ro_max = max(
            sum(len(s.readouts) for t in tasks[c0 : c0 + chunk] for s in t.solves)
            for c0 in range(0, len(tasks), chunk)
        )
        # Half-space readout convention in 3D (runtime readout_factor=0.5).
        ro_factor = 0.5 if self._is3d else 1.0
        for c0 in range(0, len(tasks), chunk):
            btasks = tasks[c0 : c0 + chunk]
            g0 = grids[c0][0]
            B = chunk
            src_i = np.zeros((B, S, MAX_SOURCES), dtype=np.int32)
            src_fac = np.zeros((B, S, MAX_SOURCES))
            ro = {k: [] for k in ("b", "s", "i0", "i1", "k", "m", "t")}

            def stage_task(bi, t, g):
                for si, s in enumerate(t.solves):
                    for k, (pos, fac) in enumerate(zip(s.source_positions, s.source_terms)):
                        src_i[bi, si, k] = g.axis_node_index(pos)
                        src_fac[bi, si, k] = fac
                    for r in s.readouts:
                        nodes = [g.axis_node_index(p) for p in r.measuring_positions]
                        ro["b"].append(bi)
                        ro["s"].append(si)
                        # |K (u1 - u0)|; single-electrode readouts use the
                        # zero-potential sentinel slot nz for u1.
                        ro["i0"].append(nodes[0])
                        ro["i1"].append(nodes[1] if len(nodes) == 2 else nz)
                        ro["k"].append(r.geometric_factor * ro_factor)
                        ro["m"].append(r.measurement_index)
                        ro["t"].append(r.tool_index)

            def ro_arrays():
                pad = ro_max - len(ro["b"])
                return dict(
                    ro_b=np.asarray(ro["b"] + [0] * pad, dtype=np.int32),
                    ro_s=np.asarray(ro["s"] + [0] * pad, dtype=np.int32),
                    ro_i0=np.asarray(ro["i0"] + [0] * pad, dtype=np.int32),
                    ro_i1=np.asarray(ro["i1"] + [nz] * pad, dtype=np.int32),
                    ro_k=np.asarray(ro["k"] + [0.0] * pad),
                    # padded rows point past the last measurement -> dropped.
                    ro_out=np.asarray(
                        list(zip(ro["m"], ro["t"])) + [(self.n_measurements, 0)] * pad,
                        dtype=np.int32,
                    ),
                )

            if self._is3d:
                np3, nr3 = spec3.np_, spec3.nr
                Lmax = max(reg[0].size for _, reg in grids)
                coords = np.tile(g0.coords[None], (B, 1, 1, 1, 1))
                free = np.tile(g0.free_mask[None], (B, 1, 1, 1))
                cshape = (B, nz - 1, np3 - 1, nr3 - 1)
                weights = np.zeros(cshape + (Lmax,), dtype=np.float32)
                uz_map_b = np.zeros((B, Lmax), dtype=np.int32)
                fz_cell = np.full(cshape, -1, dtype=np.int32)
                fixed = np.ones(cshape, dtype=bool)  # padded lanes: uniform
                sigma_fixed = np.ones(cshape)
                for bi, t in enumerate(btasks):
                    g, (uz_map, fzc) = grids[c0 + bi]
                    coords[bi] = g.coords
                    free[bi] = g.free_mask
                    weights[bi, ..., : uz_map.size] = g.region_uz_weights
                    uz_map_b[bi, : uz_map.size] = uz_map
                    fz_cell[bi] = fzc
                    fixed[bi] = g.region_fixed
                    sigma_fixed[bi] = np.where(g.region_fixed, g.sigma_cells, 1.0)
                    stage_task(bi, t, g)
                plans.append(_ChunkPlan3D(
                    coords=coords, free=free, weights=weights, uz_map=uz_map_b,
                    fz_cell=fz_cell, fixed=fixed, sigma_fixed=sigma_fixed, src_i=src_i,
                    src_fac=src_fac, **ro_arrays(),
                ))
                continue
            nr = spec.nr
            coords = np.tile(g0.coords[None], (B, 1, 1, 1))
            free = np.tile(g0.free_mask[None], (B, 1, 1))
            region = np.full((B, nz - 1, nr - 1), -1, dtype=np.int32)
            sigma_fixed = np.ones((B, nz - 1, nr - 1))
            for bi, t in enumerate(btasks):
                g, reg = grids[c0 + bi]
                coords[bi] = g.coords
                free[bi] = g.free_mask
                region[bi] = reg
                sigma_fixed[bi] = np.where(reg < 0, g.sigma_cells, 1.0)
                stage_task(bi, t, g)
            plans.append(_ChunkPlan(
                coords=coords, free=free, region=region, sigma_fixed=sigma_fixed,
                src_i=src_i, src_fac=src_fac, **ro_arrays(),
            ))
        # Chunks stacked on a leading axis, in the JAX package's types (int32
        # indices, bool masks, float32 values).
        self._stacked = {}
        for f in dataclasses.fields(plans[0]):
            a = np.stack([getattr(p, f.name) for p in plans])
            kind = a.dtype.kind
            self._stacked[f.name] = a.astype(np.int32 if kind == "i" else
                                             bool if kind == "b" else np.float32)
        self._plan = chunk_plan_to_torch(self._stacked, self.device)
        # Readout rows that land in the log (the rest pad the chunk).
        self._keep = [
            torch.as_tensor(np.flatnonzero(out[:, 0] < self.n_measurements),
                            device=self.device)
            for out in self._stacked["ro_out"]
        ]
        self.last_report = {"direct_schedule": schedule, "chunks": []}

    # ------------------------------------------------------------------ pieces
    def _chunks(self):
        for i, keep in enumerate(self._keep):
            yield {k: v[i] for k, v in self._plan.items()}, keep

    def _sigma(self, c, sigma_params):
        P = sigma_params.shape[0]
        if not self._is3d:
            region = c["region"]
            return torch.where(region >= 0, sigma_params[region.clamp(0, P - 1)],
                               c["sigma_fixed"])
        # sigma = fixed ? sigma_fixed : (invaded ? params[fz_cell]
        #         : arithmetic-blend weights @ params[uz_map])
        sigma_w = _blend(c["weights"], sigma_params[c["uz_map"].clamp(0, P - 1)])
        fz = c["fz_cell"]
        return torch.where(
            c["fixed"], c["sigma_fixed"],
            torch.where(fz >= 0, sigma_params[fz.clamp(0, P - 1)], sigma_w),
        )

    def _system(self, c, sigma):
        """Differentiable assembly of one chunk: (C, C_half, rhs, u_axis_offset).
        ``sigma``: the cell conductivities (B, cells), or (P*B, cells) for P
        copies of the chunk stacked on the batch axis."""
        P = sigma.shape[0] // c["coords"].shape[0]
        args = [c[k] if P == 1 else c[k].repeat(P, *([1] * (c[k].ndim - 1)))
                for k in ("coords", "free", "src_i", "src_fac")]
        args.insert(1, sigma)
        return _system_3d(*args, metric=self.metric3d) if self._is3d else _system_2d(*args)

    def _tangent_system(self, c, p):
        """One chunk's system and its tangents for every parameter: (C, C_half,
        rhs, offset) and (dC_half, d_rhs, d_offset) with a leading axis of P.

        The cell conductivities' tangents come from forward-mode AD of the
        gather (and 3D blend) per parameter; the assembly then runs once in
        forward mode on P copies of the chunk stacked on the batch axis, copy
        k carrying the tangent of parameter k, as ``jax.jacfwd`` batches its
        jvp over the parameters.
        """
        P = p.shape[0]
        eye = torch.eye(P, dtype=p.dtype, device=p.device)
        with fwAD.dual_level():
            sig = [fwAD.unpack_dual(self._sigma(c, 1.0 / fwAD.make_dual(p, eye[k])))
                   for k in range(P)]
            sigma = sig[0].primal
            lanes = fwAD.make_dual(
                sigma.repeat(P, *([1] * (sigma.ndim - 1))),
                torch.cat([torch.zeros_like(sigma) if x.tangent is None else x.tangent
                           for x in sig]),
            )
            system = [fwAD.unpack_dual(x) for x in self._system(c, lanes)]
        B = sigma.shape[0]
        C, C_half, rhs, offset = (x.primal[:B] for x in system)
        tangents = tuple(
            (torch.zeros_like(x.primal) if x.tangent is None else x.tangent)
            .reshape(P, B, *x.primal.shape[1:])
            for x in system[1:]
        )
        return (C, C_half, rhs, offset), tangents

    def _params(self, resistivities):
        return torch.as_tensor(resistivities, dtype=torch.float32, device=self.device)

    def _report(self, timings):
        """``last_report["chunks"]``: per chunk the solve's info (CG iterations
        and residual, the adjoint iterations once a backward pass has run),
        the seconds of its assembly, factorization and solves (``assembly_s``,
        ``factor_s``, ``solve_s``: CUDA events on a card) and the host's
        seconds of each of its spans (``host_s``: "assembly", "factor",
        "solve", and "tangent" of the Jacobian's tangent solve)."""
        with span("report_sync"):
            if self.device.type == "cuda":  # the events of the last chunk have passed
                torch.cuda.synchronize(self.device)
        for info, seconds, host in timings:
            info.update({f"{name}_s": fn() for name, fn in seconds.items()})
            info["host_s"] = dict(host.seconds)
        self.last_report["chunks"] = [info for info, _, _ in timings]

    def _scatter(self, vals, index):
        m, t = index.unbind(-1)
        out = torch.full((self.n_measurements, self.n_tools) + tuple(vals.shape[1:]),
                         float("nan") if vals.ndim == 1 else 0.0,
                         dtype=vals.dtype, device=vals.device)
        return out.index_put((m, t), vals)

    # ------------------------------------------------------------------ forward
    @span("forward")
    def __call__(self, resistivities):
        """Log matrix (n_measurements, n_tools) for a resistivity vector.

        A differentiable torch function of ``resistivities`` (ohm-m,
        :attr:`param_names` order); entries never measured stay NaN (parity
        with Model.simulate_logs). ``torch.autograd.grad`` of it costs one
        adjoint solve per chunk.
        """
        p = self._params(resistivities)
        vals, index, timings = [], [], []
        for c, keep in self._chunks():
            info, seconds, host = {}, {}, PhaseTimers()
            timings.append((info, seconds, host))
            with _timed(seconds, "assembly", self.device, host):
                C, C_half, rhs, offset = self._system(c, self._sigma(c, 1.0 / p))
            with _timed(seconds, "factor", self.device, host):
                M_inv = _preconditioner(C, self.direct_schedule, self.factor_passes)
            with _timed(seconds, "solve", self.device, host):
                w = linear_solve(C_half, rhs, M_inv, tol=self.tol, maxiter=self.maxiter,
                                 info=info)
            u_axis = _axis(w, self._is3d) + offset
            vals.append(torch.abs(_readout(c, u_axis))[keep])
            index.append(c["ro_out"][keep])
        self._report(timings)
        return self._scatter(torch.cat(vals), torch.cat(index))

    def forward(self, resistivities):
        """:meth:`__call__` without recording a graph."""
        with torch.no_grad():
            return self(resistivities)

    @span("jacobian")
    def jacobian(self, resistivities):
        """d(log)/d(resistivity): (n_measurements, n_tools, P), forward mode.

        Per chunk, the tangents of the operator and of the load for every
        parameter come from one forward-mode AD pass of the assembly
        (:meth:`_tangent_system`); then one PCG call solves every parameter's
        tangent system as extra right-hand sides on the chunk's
        factorization. Entries never measured are 0 (the
        derivative of the constant NaN fill, as ``jax.jacfwd`` gives it).
        """
        p = self._params(resistivities).detach()
        vals, index, timings = [], [], []
        with torch.no_grad():
            for c, keep in self._chunks():
                info, seconds, host = {}, {}, PhaseTimers()
                timings.append((info, seconds, host))
                with _timed(seconds, "assembly", self.device, host):
                    (C, C_half, rhs, offset), (dC_half, d_rhs, d_offset) = \
                        self._tangent_system(c, p)
                with _timed(seconds, "factor", self.device, host):
                    M_inv = _preconditioner(C, self.direct_schedule, self.factor_passes)
                with _timed(seconds, "solve", self.device, host):
                    w = linear_solve(C_half, rhs, M_inv, tol=self.tol, maxiter=self.maxiter,
                                     info=info)
                    with span("tangent"):
                        dw = solve_tangents(C_half, dC_half, d_rhs, w, M_inv, tol=self.tol,
                                            maxiter=self.maxiter, info=info)
                del dC_half, d_rhs
                d = _readout(c, _axis(w, self._is3d) + offset)
                dd = _readout(c, _axis(dw, self._is3d) + d_offset)  # (P, RO)
                vals.append((torch.sign(d) * dd).T[keep])  # d|x| = sign(x) dx
                index.append(c["ro_out"][keep])
        self._report(timings)
        return self._scatter(torch.cat(vals), torch.cat(index))


@highest_matmul_precision
def _blend(weights, sig_uz):
    """The 3D arithmetic sub-cell blend, in full float32 whatever the caller's
    TF32 setting."""
    return torch.einsum("bzprl,bl->bzpr", weights, sig_uz)


def _axis(w, is3d: bool):
    """Axis potentials of a solution: (..., NZ, NR) -> (..., NZ); in 3D
    (..., NZ, NP, NR) -> (..., NZ), the azimuthal mean of the tied pole ring."""
    return w[..., 0].mean(dim=-1) if is3d else w[..., 0]


def _readout(c, u_axis):
    """K (u1 - u0) of every staged readout row from axis potentials (..., B,
    S, NZ) -> (..., RO); u1 of a single-electrode readout is the
    zero-potential sentinel slot NZ. The log is its absolute value."""
    u_pad = F.pad(u_axis, (0, 1))
    u0 = u_pad[..., c["ro_b"], c["ro_s"], c["ro_i0"]]
    u1 = u_pad[..., c["ro_b"], c["ro_s"], c["ro_i1"]]
    return c["ro_k"] * (u1 - u0)


def _system_2d(coords, sigma, free, src_i, src_fac):
    """2D assembly, singularity-subtracted load and Dirichlet lift
    (``remo3d_tpu.diff._solve_chunk_diff`` up to its solve). Returns the
    eliminated stencil C, its half storage, the load and the (g_lift + u_s)
    axis offset of the solution (B, S, NZ)."""
    nz, nr = coords.shape[-3], coords.shape[-2]
    C_raw = fold_to_stencil(element_matrices_2d(coords, sigma), nz, nr)
    C = apply_dirichlet(C_raw, free)
    rhs, g_lift, u_s = _build_rhs2_subtract(coords, sigma, free, src_i, src_fac, C_raw)
    return C, half_planes_2d(C), rhs, (g_lift + u_s)[..., 0]


def _system_3d(coords, sigma, free, src_i, src_fac, metric="cartesian"):
    """3D hex assembly, singularity-subtracted, lifted and pole-projected load
    (``remo3d_tpu.diff._solve_chunk_diff_3d`` up to its solve); the lift's
    product with the raw stencil goes through K2. Returns as
    :func:`_system_2d`."""
    C_raw, C = _assemble3(coords, sigma, free, metric=metric)
    rhs, offset = _build_rhs3_subtract(
        coords, sigma, free, src_i, src_fac, _apply3(C_raw, True), metric=metric
    )
    return C, half_planes_3d(C), rhs, offset


@torch.no_grad()
def _preconditioner(C, schedule, passes):
    """The block-direct factorization of the detached operator C, as the
    apply r -> M^{-1} r (3D: P apply(P r), the axis DOFs tied)."""
    C = C.detach()
    if C.shape[-2:] == (3, 3):  # 2D: (B, NZ, NR, 3, 3); 3D: (B, NZ, NP, NR, 27)
        return _factor2_direct(C, schedule=schedule, passes=passes)
    np_, nr = C.shape[2], C.shape[3]
    apply = _factor3_direct(C, np_=np_, nr=nr, schedule=schedule, passes=passes)
    return lambda r: pole_project(apply(pole_project(r)))


def _solve_chunk_diff(coords, sigma, free, src_i, src_fac, *, tol, maxiter,
                      schedule="scan", factor_passes=None, info=None):
    """One 2D chunk's axis potentials (B, S, NZ), differentiable in ``sigma``.

    Mirrors ``remo3d_tpu.diff._solve_chunk_diff``: the solve is
    :func:`~remo3d_tpu_torch.ops.linear_solve.linear_solve` on the K1 operator
    with the detached factorization as preconditioner, so derivatives cost
    one more solve instead of differentiating through the CG loop.
    """
    C, C_half, rhs, offset = _system_2d(coords, sigma, free, src_i, src_fac)
    M_inv = _preconditioner(C, schedule, factor_passes)
    w = linear_solve(C_half, rhs, M_inv, tol=tol, maxiter=maxiter, info=info)
    return _axis(w, False) + offset


def _solve_chunk_diff_3d(coords, sigma, free, src_i, src_fac, *, tol, maxiter,
                         schedule="scan", factor_passes=None, metric="cartesian", info=None):
    """One 3D chunk's axis potentials (B, S, NZ), differentiable in ``sigma``.

    Mirrors ``remo3d_tpu.diff._solve_chunk_diff_3d``: hex assembly,
    singularity subtraction, the solve on the pole-tied K2 operator P A P
    with the detached banded-block factorization, and the readout as the
    azimuthal mean of the tied pole ring plus the analytic offset.
    """
    C, C_half, rhs, offset = _system_3d(coords, sigma, free, src_i, src_fac, metric=metric)
    M_inv = _preconditioner(C, schedule, factor_passes)
    w = linear_solve(C_half, rhs, M_inv, tol=tol, maxiter=maxiter, info=info)
    return _axis(w, True) + offset
