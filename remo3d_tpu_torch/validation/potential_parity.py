# -*- coding: utf-8 -*-
"""Potential-level parity in float64 (the JAX package's
``benchmarks/potential_parity.py``), on the card.

Two measurements of the 2D solver's axis potentials, both in float64 with the
CG residual driven to 1e-13:

* ``oracle``: FEM potentials against the float64 finite-volume oracle
  (:mod:`.fv_oracle`, another discretization and a sparse direct solve) at
  receiver offsets -4..+4 m around a source, on the BM1-like bed ladder (and
  the BM2-like invaded beds with ``--case BM2-like``). This bounds the
  discretization parity between two unrelated float64 methods.
* ``converge``: FEM self-convergence under uniform refinement of every grid
  axis (1x, 2x, 4x): the potentials' change between consecutive levels, the
  observed order (2 for the Q1 elements) and the Richardson estimate of the
  distance to the mesh limit.

The FEM runs on ``device`` (float64 is native on the H100); the oracle runs on
the host's CPU.

    python -m remo3d_tpu_torch.validation.potential_parity [--cpu] [oracle|converge|all]
        [--case BM1-like|BM2-like] [--depth Z] [--scales 1,2,4]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .models import BM1_FORMATION, BM1_RHO_MUD, BM1_RW, BM2_FORMATION, BM2_RHO_MUD, BM2_RW

R_DOM = 50.0
# Receiver offsets (m) from the source: the short-normal to long-lateral range.
OFFSETS = np.array([-4.0, -2.0, -1.0, -0.5, 0.5, 1.0, 2.0, 4.0])
# Per case: formation, rw, mud and source depths (bed centres and a source
# 0.5 m off a bed boundary).
CASES = {
    "BM1-like": (BM1_FORMATION, BM1_RW, BM1_RHO_MUD, [13.0, 14.5, 22.0, 36.0]),
    "BM2-like": (BM2_FORMATION, BM2_RW, BM2_RHO_MUD, [10.0, 30.0, 50.0]),
}
CONVERGE_DEPTH = 13.0


def fem_axis_potentials(
    formation, z_src, offsets, spec=None, rw=0.1, rho_mud=1.0, tol=1e-13, maxiter=4000,
    preconditioner="multigrid", dtype=torch.float64, device="cuda",
):
    """One single-source FEM solve; returns (u at ``offsets``, relative
    residual, CG iterations). The production chunk solve
    (``parallel/runtime.py``) on one hand-staged batch, the receivers pinned
    as electrode nodes so the readout needs no interpolation."""
    from ..convert import chunk_to_torch
    from ..meshing.carve import carve_local_model
    from ..meshing.grid2d import GridSpec2D, build_grid2d
    from ..parallel.runtime import _solve_chunk, _solve_chunk_direct

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass device='cpu' to run on the CPU")
    spec = spec or GridSpec2D()
    borehole = np.array([[-1000.0, rw, rho_mud], [1000.0, rw, rho_mud]])
    lm = carve_local_model(formation, borehole[:, :2], rho_mud, z_src, R_DOM)
    # Receivers and the source are pinned grid lines.
    pinned = np.unique(np.concatenate([np.asarray(offsets, float), [0.0]]))
    grid = build_grid2d(spec, R_DOM, lm, pinned, np.array([0.0]))
    src_i = np.full((1, 1, 2), grid.axis_node_index(0.0), dtype=np.int64)
    src_fac = np.zeros((1, 1, 2))
    src_fac[0, 0, 0] = 1.0
    args = chunk_to_torch([grid.coords[None], grid.sigma_cells[None], grid.free_mask[None],
                           src_i, src_fac], device, dtype)
    if preconditioner == "direct":
        u_axis, res, iters = _solve_chunk_direct(*args, tol=tol, maxiter=maxiter)
    else:
        u_axis, res, iters = _solve_chunk(*args, tol=tol, maxiter=maxiter,
                                          preconditioner=preconditioner)
    u_axis = u_axis[0, 0].cpu().numpy()
    u = np.array([u_axis[grid.axis_node_index(o)] for o in offsets])
    return u, float(res[0, 0]), int(iters)


def fv_axis_potentials(formation, z_src, offsets, rw=0.1, rho_mud=1.0, n_base=3001,
                       n_r_out=220):
    """Float64 FV-oracle potentials at z_src + offsets (exact grid nodes)."""
    from .fv_oracle import _build_r_grid, _build_z_grid, fv_solve_axis

    formation = np.asarray(formation, float)
    bounds = formation[:-1, 1]
    rho_uz = formation[:, 4]
    fz_radius = formation[:, 2]
    rho_fz = formation[:, 3]
    receivers = z_src + np.asarray(offsets, float)

    z = _build_z_grid(z_src, receivers, bounds, R_DOM, n_base, 0.004)
    inv = fz_radius[np.isfinite(fz_radius)]
    r = _build_r_grid(rw, np.unique(inv), R_DOM, 9, n_r_out)

    def sigma_of_cells(zc, rc):
        li = np.clip(np.searchsorted(bounds, zc), 0, rho_uz.size - 1)
        sig = np.empty((zc.size, rc.size))
        sig[:] = (1.0 / rho_uz[li])[:, None]
        has_fz = np.isfinite(fz_radius[li]) & np.isfinite(rho_fz[li])
        in_fz = has_fz[:, None] & (
            rc[None, :] < np.where(has_fz, fz_radius[li], 0.0)[:, None]
        )
        sig = np.where(in_fz, (1.0 / np.where(has_fz, rho_fz[li], 1.0))[:, None], sig)
        sig[:, rc < rw] = 1.0 / rho_mud
        return sig

    u_axis = fv_solve_axis(z_src, sigma_of_cells, z, r, subtract_sigma0=1.0 / rho_mud)
    return np.array([u_axis[int(np.where(z == zr)[0][0])] for zr in receivers])


def run_oracle(case="BM1-like", depths=None, device="cuda", spec=None, fv=None):
    """FEM against FV at each source depth of ``case``; returns the worst
    relative potential difference."""
    formation, rw, mud, case_depths = CASES[case]
    print(f"FEM (float64, tol 1e-13, {device}) vs FV oracle (float64, direct) axis potentials, "
          f"{case}; offsets {OFFSETS}", flush=True)
    worst = 0.0
    for zs in case_depths if depths is None else depths:
        t0 = time.perf_counter()
        u_fem, res, iters = fem_axis_potentials(formation, zs, OFFSETS, spec=spec, rw=rw,
                                                rho_mud=mud, device=device)
        t_fem = time.perf_counter() - t0
        t0 = time.perf_counter()
        u_fv = fv_axis_potentials(formation, zs, OFFSETS, rw=rw, rho_mud=mud, **(fv or {}))
        rel = np.abs(u_fem / u_fv - 1.0)
        worst = max(worst, float(rel.max()))
        print(f"  {case} z_src={zs:5.1f}: max {rel.max():.2e} mean {rel.mean():.2e}  (CG res "
              f"{res:.1e}, {iters} iterations, FEM {t_fem:.1f} s, FV "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[oracle] worst FEM-vs-FV relative potential difference: {worst:.2e}", flush=True)
    return worst


def scaled_spec(s: int, base=None):
    """Refine ``base`` (default: the default grid) uniformly: s x the node
    lines, 1/s the spacing floors and slopes."""
    from ..meshing.grid2d import GridSpec2D

    d = base or GridSpec2D()
    return dataclasses.replace(
        d,
        nz=s * (d.nz - 1) + 1,
        nr=s * (d.nr - 1) + 1,
        h_min_source=d.h_min_source / s,
        slope_source=d.slope_source / s,
        h_min_electrode=d.h_min_electrode / s,
        slope_electrode=d.slope_electrode / s,
        h_min_boundary=d.h_min_boundary / s,
        slope_boundary=d.slope_boundary / s,
        h_max_axial_frac=d.h_max_axial_frac / s,
        h_min_radial=d.h_min_radial / s,
        slope_radial=d.slope_radial / s,
        h_max_radial_frac=d.h_max_radial_frac / s,
    )


def run_converge(scales=(1, 2, 4), depth=CONVERGE_DEPTH, device="cuda", base=None):
    """The refinement ladder on the BM1-like model; returns {"deltas": the max
    relative change between consecutive levels, "order": the observed order
    per offset (three levels or more), "remaining": the Richardson estimate at
    the finest level}."""
    formation, rw, mud, _ = CASES["BM1-like"]
    print(f"float64 self-convergence on {device}, BM1-like z_src={depth} (tol 1e-13)", flush=True)
    us = []
    for s in scales:
        t0 = time.perf_counter()
        spec = scaled_spec(s, base)
        u, res, iters = fem_axis_potentials(formation, depth, OFFSETS, spec=spec, rw=rw,
                                            rho_mud=mud, device=device)
        us.append(u)
        print(f"  scale {s} ({spec.nz}x{spec.nr}): CG res {res:.1e}, {iters} iterations, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = {"deltas": [], "order": None, "remaining": None}
    for a in range(len(scales) - 1):
        rel = np.abs(us[a + 1] / us[a] - 1.0)
        out["deltas"].append(float(rel.max()))
        print(f"  |u({scales[a + 1]}x) - u({scales[a]}x)| / u: max {rel.max():.2e} "
              f"mean {rel.mean():.2e}")
    if len(scales) >= 3:
        # Second-order elements: error(h) ~ C h^2, so the next delta is ~1/4 of
        # the last and the finest level sits ~delta/3 from the mesh limit.
        d12 = np.abs(us[-2] - us[-3])
        d24 = np.abs(us[-1] - us[-2])
        out["order"] = np.log2(np.where(d24 > 0, d12 / np.maximum(d24, 1e-300), 1.0))
        out["remaining"] = np.abs(d24 / 3.0 / us[-1])
        print(f"  observed convergence order per offset: {np.round(out['order'], 2)}")
        print(f"  Richardson remaining-error estimate at {scales[-1]}x: max "
              f"{out['remaining'].max():.2e} mean {out['remaining'].mean():.2e}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="all", choices=["oracle", "converge", "all"])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--case", default=None, choices=list(CASES))
    ap.add_argument("--depth", type=float, default=None)
    ap.add_argument("--scales", default="1,2,4")
    a = ap.parse_args()
    device = "cpu" if a.cpu else "cuda"
    if a.which in ("oracle", "all"):
        for case in [a.case] if a.case else list(CASES):
            run_oracle(case, None if a.depth is None else [a.depth], device)
    if a.which in ("converge", "all"):
        run_converge([int(s) for s in a.scales.split(",")],
                     CONVERGE_DEPTH if a.depth is None else a.depth, device)
