# -*- coding: utf-8 -*-
"""The plain reference of a synthetic log: the same plan, grids and finite
element system as the program's, solved directly in float64.

From a configuration's tables and a list of batch indices it plans the log
(:mod:`.planner`), carves each batch's local model (:mod:`.carve`), builds its
boundary-fitted grid on the host in numpy (:mod:`.grid2d`, :mod:`.grid3d`),
assembles the stencil and the singularity-subtracted load (:mod:`.assembly2d`,
:mod:`.assembly3d`), solves it with :mod:`.solve` and reads the apparent
resistivities off the axis. Every module here is a frozen copy or a plain
rewrite; nothing of the program is imported, and nothing the program made is
read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import io as mio
from .assembly2d import (
    apply_dirichlet,
    element_matrices_2d,
    fold_to_stencil,
    fundamental_potential_2d,
    singularity_rhs_2d,
)
from .assembly3d import (
    apply_dirichlet_3d,
    element_matrices_3d,
    fold_to_stencil_3d,
    fundamental_potential_3d,
    singularity_rhs_3d,
)
from .carve import carve_local_model
from .grid2d import GridSpec2D, build_grid2d
from .grid3d import GridSpec3D, build_grid3d
from .planner import plan_tasks
from .solve import solve_2d, solve_3d_pole_tied, working_dtype
from .stencil3d import pole_project, stencil3d_apply
from .tools import parse_tools

DOMAIN_RADIUS = 50.0
BATCH_SIZE = 5  # depths per mesh, the public API's default
MAX_SOURCES = 2


@dataclasses.dataclass
class Case:
    """One log: tools, depths, tables (formation rows [TOP, BOTTOM, FZ_RADIUS,
    FZ_RHO, UZ_RHO], borehole rows [DEPTH, RADIUS, MUD_RHO]), dip (degrees),
    the grid's spec fields and the 3D assembly metric."""

    tools: list
    depths: np.ndarray
    formation: np.ndarray
    borehole: np.ndarray
    dip: float
    grid: dict
    metric3d: str = "cylindrical"

    @property
    def is3d(self) -> bool:
        return not np.isclose(self.dip, 0)


class Plan:
    """The plan of a case's log: its batch tasks and what each grid needs."""

    def __init__(self, case: Case):
        self.case = case
        formation = mio.set_formation_parameters(np.asarray(case.formation, float), ["M"] * 3)
        borehole = mio.set_borehole_parameters(np.asarray(case.borehole, float), "radius",
                                               ["M", "M"])
        _, self.dip_rad = mio.set_dip(case.dip)
        if case.is3d:
            borehole = mio.add_points_to_borehole(borehole)
        self.formation, self.borehole = formation, borehole
        self.tools, sec = parse_tools(list(case.tools), True)
        sim_depths, self.tasks = plan_tasks(self.tools, sec, np.asarray(case.depths, float),
                                            BATCH_SIZE)
        self.mud = np.interp(sim_depths, borehole[:, 0], borehole[:, 2])
        self.spec = (GridSpec3D if case.is3d else GridSpec2D)(**case.grid)
        self.window = 0.99 if case.is3d else 0.999

    def grid(self, b: int, formation=None):
        """Batch b's grid, under ``formation`` (the case's table if None)."""
        t = self.tasks[b]
        lm = carve_local_model(self.formation if formation is None else formation,
                               self.borehole[:, :2], float(self.mud[t.batch_index]),
                               t.center_depth, DOMAIN_RADIUS, dip_rad=self.dip_rad,
                               active_geometry_window=self.window)
        sources = np.unique(np.concatenate([s.source_positions for s in t.solves]))
        if self.case.is3d:
            return build_grid3d(self.spec, DOMAIN_RADIUS, lm, self.dip_rad,
                                t.electrode_positions, sources)
        return build_grid2d(self.spec, DOMAIN_RADIUS, lm, t.electrode_positions, sources)


def _stencil_apply_2d(C, u):
    """y = A u for C (B, NZ, NR, 3, 3), u (B, S, NZ, NR)."""
    nz, nr = C.shape[-4], C.shape[-3]
    Cb = C.unsqueeze(1)
    u_pad = F.pad(u, (1, 1, 1, 1))
    y = torch.zeros_like(u)
    for di in range(3):
        for dj in range(3):
            y = y + Cb[..., di, dj] * u_pad[..., di: di + nz, dj: dj + nr]
    return y


def _axis_potentials(plan: Plan, grids, precision: str, device) -> torch.Tensor:
    """u on the axis (B, S, NZ) of the batches whose grids are ``grids``."""
    dtype = working_dtype(precision)
    tasks = [plan.tasks[b] for b in grids]
    gs = list(grids.values())
    S = max(len(t.solves) for t in tasks)
    B = len(gs)
    src_i = np.zeros((B, S, MAX_SOURCES), dtype=np.int64)
    src_fac = np.zeros((B, S, MAX_SOURCES))
    for bi, (t, g) in enumerate(zip(tasks, gs)):
        for si, s in enumerate(t.solves):
            for k, (pos, fac) in enumerate(zip(s.source_positions, s.source_terms)):
                src_i[bi, si, k] = g.axis_node_index(pos)
                src_fac[bi, si, k] = fac

    def put(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    coords = put(np.stack([g.coords for g in gs]))
    sigma = put(np.stack([g.sigma_cells for g in gs]))
    free = put(np.stack([g.free_mask for g in gs]), torch.bool)
    src_i = put(src_i, torch.int64)
    src_fac = put(src_fac)
    nz = coords.shape[1]
    freeb = free[:, None]
    if plan.case.is3d:
        metric = plan.case.metric3d
        n3 = coords.shape[1:4]
        C_raw = fold_to_stencil_3d(element_matrices_3d(coords, sigma, metric=metric), *n3)
        C = apply_dirichlet_3d(C_raw, free)
        sigma0 = sigma[:, 0, 0, 0]
        z_axis = coords[:, :, 0, 0, 2]
        src_z = torch.gather(z_axis[:, None, :].expand(B, S, nz), 2, src_i)
        u_s = fundamental_potential_3d(coords, sigma0, src_z, src_fac)
        rhs = singularity_rhs_3d(coords, sigma, sigma0, src_z, src_fac, metric=metric)
        g_lift = torch.where(freeb, torch.zeros_like(u_s), -u_s)
        rhs = rhs - stencil3d_apply(C_raw, g_lift)
        rhs = pole_project(torch.where(freeb, rhs, torch.zeros_like(rhs)))
        return solve_3d_pole_tied(C, rhs, precision) + (g_lift + u_s)[..., :, 0, 0]
    n2 = coords.shape[1:3]
    C_raw = fold_to_stencil(element_matrices_2d(coords, sigma), *n2)
    C = apply_dirichlet(C_raw, free)
    sigma0 = sigma[:, 0, 0]
    z_axis = coords[:, :, 0, 0]
    src_z = torch.gather(z_axis[:, None, :].expand(B, S, nz), 2, src_i)
    u_s = fundamental_potential_2d(coords, sigma0, src_z, src_fac)
    rhs = singularity_rhs_2d(coords, sigma, sigma0, src_z, src_fac)
    g_lift = torch.where(freeb, torch.zeros_like(u_s), -u_s)
    rhs = rhs - _stencil_apply_2d(C_raw, g_lift)
    rhs = torch.where(freeb, rhs, torch.zeros_like(rhs))
    return (solve_2d(C, rhs, precision) + g_lift + u_s)[..., 0]


def readouts(plan: Plan, batches, *, formation=None, precision="float64", device="cpu",
             block=8) -> dict:
    """{(measurement index, tool index): apparent resistivity} of every
    readout of the given batches, ``block`` batches solved at a time."""
    out = {}
    factor = 0.5 if plan.case.is3d else 1.0  # the half-ball carries the full current
    batches = list(batches)
    for lo in range(0, len(batches), block):
        grids = {b: plan.grid(b, formation) for b in batches[lo: lo + block]}
        u_axis = _axis_potentials(plan, grids, precision, device).double().cpu().numpy()
        for bi, (b, g) in enumerate(grids.items()):
            for si, s in enumerate(plan.tasks[b].solves):
                for ro in s.readouts:
                    pots = [u_axis[bi, si, g.axis_node_index(p)] for p in ro.measuring_positions]
                    diff = pots[1] - pots[0] if len(pots) == 2 else pots[0]
                    out[(ro.measurement_index, ro.tool_index)] = abs(
                        ro.geometric_factor * diff) * factor
        del u_axis
    return out
