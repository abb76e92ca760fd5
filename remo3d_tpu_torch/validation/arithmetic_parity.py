# -*- coding: utf-8 -*-
"""Arithmetic fidelity: the float32 solve against float64 on the same
discretization (the JAX package's ``benchmarks/arithmetic_parity.py``).

Same discretization, two precisions, so the solver's arithmetic is measured
apart from the discretization error (which the oracle scripts anchor). Three
modes:

* ``ra2d``: a 2D log's apparent resistivities, float32 at tol 3e-7 (the
  device's default preconditioner: multigrid on the card) against float64
  through the direct preconditioner at tol 1e-10. Default workload: the
  6-tool, 101-depth (0..10 m) log of the inline BM2-like model on the
  761x161 grid.
* ``u2d``: the axis potentials of one real batch (5.0 m, A2.0M0.5N), float32
  at tol 3e-7 against float64 at tol 1e-13, both direct, over the nodes whose
  potential exceeds 1e-3 of the largest.
* ``ra3d``: the BM3 log at dip 30 (3 depths 14.0..14.5 m, A2.0M0.5N), float32
  at tol 1e-5 against float64 at tol 1e-12, both direct, chunks of 2.

    python -m remo3d_tpu_torch.validation.arithmetic_parity [--cpu] [ra2d|u2d|ra3d|all]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .models import BM2_BOREHOLE, BM2_FORMATION, BM3_BOREHOLE, BM3_FORMATION, EXAMPLE01_TOOLS


def _logs(tools, depths, formation, borehole, dtype, tol, device, dip=0, **simulate):
    from ..model import Model

    m = Model(tools)
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius", dip=dip)
    m.initialize_workers(cpu_workers=1)
    m.simulate_logs(depths, device=device, verbose=False, dtype=dtype, tol=tol, **simulate)
    return np.stack([m.logs[t][:, 1] for t in tools], axis=1)


def spread(f32, f64) -> dict:
    """|f32 / f64 - 1| of two (depths, tools) logs: per tool max, overall max
    and root mean square."""
    rel = np.abs(f32 / f64 - 1)
    return {"per_tool": rel.max(axis=0), "max": float(rel.max()),
            "rms": float(np.sqrt(np.mean(rel**2))), "rel": rel}


def ra2d(tools=EXAMPLE01_TOOLS, depths=np.arange(0.0, 10.01, 0.1), device="cuda", **simulate):
    """The float32 log (the device's own preconditioner) against float64
    (direct, tol 1e-10); ``simulate`` goes to both runs."""
    f32 = _logs(tools, depths, BM2_FORMATION, BM2_BOREHOLE, "float32", 3e-7, device, **simulate)
    f64 = _logs(tools, depths, BM2_FORMATION, BM2_BOREHOLE, "float64", 1e-10, device,
                preconditioner="direct", **simulate)
    s = spread(f32, f64)
    for t, v in zip(tools, s["per_tool"]):
        print(f"  {t}: max {v:.3e}")
    print(f"[ra2d] {len(depths)} depths x {len(tools)} tools on {device}: f32-vs-f64 Ra spread "
          f"max {s['max']:.3e}, rms {s['rms']:.3e}", flush=True)
    return s


def ra3d(depths=np.arange(14.0, 14.6, 0.25), device="cuda", **simulate):
    """BM3 at dip 30: float32 at tol 1e-5 against float64 at tol 1e-12."""
    ov = {"chunk_size_3d": 2, "precond3d": "direct"}
    kw = {"executor_overrides": ov, **simulate}
    f64 = _logs(["A2.0M0.5N"], depths, BM3_FORMATION, BM3_BOREHOLE, "float64", 1e-12, device,
                dip=30, **kw)
    f32 = _logs(["A2.0M0.5N"], depths, BM3_FORMATION, BM3_BOREHOLE, "float32", 1e-5, device,
                dip=30, **kw)
    s = spread(f32, f64)
    print(f"[ra3d] BM3 dip=30, {len(depths)} depths on {device}: f32-vs-f64 Ra spread max "
          f"{s['max']:.3e}, mean {float(s['rel'].mean()):.3e}", flush=True)
    return s


def u2d(device="cuda", depth=5.0, grid_spec=None):
    """Axis potentials of one batch, float32 against float64; returns (max, mean)
    over the significant nodes."""
    from ..convert import chunk_to_torch
    from ..meshing.carve import carve_local_model
    from ..meshing.grid2d import GridSpec2D, build_grid2d
    from ..parallel.runtime import _solve_chunk_direct
    from ..planner import plan_tasks
    from ..tools import parse_tools

    tools, sec = parse_tools(["A2.0M0.5N"], True)
    task = plan_tasks(tools, sec, np.array([depth]), 5)[1][0]
    lm = carve_local_model(BM2_FORMATION, BM2_BOREHOLE[:, :2], BM2_BOREHOLE[0, 2],
                           task.center_depth, 50.0, active_geometry_window=0.999)
    sources = np.unique(np.concatenate([s.source_positions for s in task.solves]))
    g = build_grid2d(grid_spec or GridSpec2D(), 50.0, lm, task.electrode_positions, sources)
    src_i = np.full((1, 1, 2), g.axis_node_index(task.solves[0].source_positions[0]), np.int64)
    src_fac = np.array([[[1.0, 0.0]]])
    arrays = [g.coords[None], g.sigma_cells[None], g.free_mask[None], src_i, src_fac]

    def solve(dtype, tol):
        u, _, _ = _solve_chunk_direct(*chunk_to_torch(arrays, device, dtype), tol=tol,
                                      maxiter=200)
        return u[0, 0].double().cpu().numpy()

    u64 = solve(torch.float64, 1e-13)
    u32 = solve(torch.float32, 3e-7)
    mask = np.abs(u64) > 1e-3 * np.abs(u64).max()
    rel = np.abs(u32[mask] - u64[mask]) / np.abs(u64[mask])
    print(f"[u2d] axis-potential f32-vs-f64 parity on {device} (significant nodes, "
          f"n={mask.sum()}): max {rel.max():.2e} mean {rel.mean():.2e}", flush=True)
    return float(rel.max()), float(rel.mean())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all", choices=["ra2d", "u2d", "ra3d", "all"])
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    device = "cpu" if a.cpu else "cuda"
    for mode, fn in (("ra2d", ra2d), ("ra3d", ra3d), ("u2d", u2d)):
        if a.which in (mode, "all"):
            fn(device=device)
