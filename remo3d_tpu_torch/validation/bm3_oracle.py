# -*- coding: utf-8 -*-
"""Benchmark model 3 (dipping layers): the 3D solver against the rotated
layered-medium oracle (the JAX package's ``benchmarks/bm3_oracle.py``).

A dipping-layer full space is a rigid rotation of a horizontal layer stack:
rotating the frame by the dip angle a maps the dipping planes (which cross the
borehole axis at the formation's depths) to horizontal ones, and the tool axis
to a line tilted by a. With a negligible borehole the problem is then exactly
the 1D layered-medium problem at off-axis points:

    boundaries' = boundaries * cos(a)       (axis-crossing depth -> true depth)
    electrode at axis position t -> z' = t*cos(a), and relative to the source
    at t_s the horizontal offset is r = |t - t_s|*sin(a)

so the potential follows from the Hankel oracle with the J0 kernel
(:mod:`remo3d_tpu_torch.utils.layered_oracle`, off-axis mode), with no FEM in
the loop. The model is the BM3 stack (10 | 100 | 10 ohm-m, bed 10.77..14.23 m
along the axis) with the borehole shrunk to 0.002 m radius and the mud matched
to the shoulders, so the only physics is the dipping layers: at 0.01 m the mud
needle is real physics the oracle lacks (the JAX package measured 2.36% at dip
30 against 0.93% at 0.002 m). The FEM truncates at ``domain_radius`` with
u = 0, a ~d/R potential shift: R = 150 m (default here) leaves it below the
discretization error.

    python -m remo3d_tpu_torch.validation.bm3_oracle [--cpu] [--dips=15,30,45,60]
        [--tools=A2.0M0.5N,A1.0M0.2N] [-v]

Dips of 50 and more run on ``GridSpec3D.high_dip()`` (the ``Model`` chooses it).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..tools import parse_tools
from ..utils.layered_oracle import LayeredOracle
from .models import BM3_BOUNDARIES as BOUNDARIES
from .models import BM3_RHOS as RHOS

BH_RADIUS = 0.002  # negligible borehole (the needle effect goes with radius^2)
MUD_RHO = 10.0  # matched to the shoulders
DOMAIN_RADIUS = 150.0  # truncation shift ~ d/R
DIPS = [15, 30, 45, 60]
TOOLS = ["A2.0M0.5N", "A1.0M0.2N"]
# Depths span shoulder - bed - shoulder: 19 depths 8..17 m.
DEPTHS = np.round(np.arange(8.0, 17.01, 0.5), 4)


def oracle_log(tool_name, depths, dip_deg, boundaries=BOUNDARIES, rhos=RHOS,
               n_lambda=6000, lam_max=100.0):
    """Apparent-resistivity log from the rotated layered-medium oracle."""
    tools, _ = parse_tools([tool_name], True)
    tp = tools[tool_name]
    c = np.cos(np.deg2rad(dip_deg))
    s = np.sin(np.deg2rad(dip_deg))
    oracle = LayeredOracle(
        boundaries * c, 1.0 / rhos, n_lambda=n_lambda, lam_max=lam_max
    )
    # Source at axis offset 0 (the geometry is current-electrode-centred);
    # measuring electrodes at the zero-source offsets.
    rec_offs = tp.geometry[tp.source_terms == 0]
    out = np.empty(len(depths))
    for i, d in enumerate(depths):
        t_src = d + tp.depth_shift
        t_rec = t_src + rec_offs
        u = oracle.potentials(
            np.array([t_src * c]),
            t_rec * c,
            r_receivers=np.abs(rec_offs) * s,
        )[0]
        du = u[0] - u[1] if u.size == 2 else u[0]
        out[i] = abs(tp.geometric_factor * du)
    return out


def bm3_formation(boundaries=BOUNDARIES, rhos=RHOS) -> np.ndarray:
    """The BM3 stack as a formation table (no invasion)."""
    return np.column_stack(
        [
            np.concatenate([[-1000.0], boundaries]),
            np.concatenate([boundaries, [1000.0]]),
            np.full(len(rhos), np.nan),
            np.full(len(rhos), np.nan),
            rhos,
        ]
    )


def fem_log(tool_name, depths, dip_deg, device="cuda", grid_spec3d=None, tol=None,
            domain_radius=DOMAIN_RADIUS, bh_radius=BH_RADIUS, **simulate):
    """The FEM log of ``tool_name`` through the BM3 stack at ``dip_deg``;
    ``simulate`` goes to ``Model.simulate_logs`` (``dtype``, ...)."""
    from ..model import Model

    borehole = np.array([[-1000.0, bh_radius, MUD_RHO], [1000.0, bh_radius, MUD_RHO]])
    m = Model([tool_name])
    m.set_model_parameters(bm3_formation(), borehole, borehole_geometry_type="radius",
                           dip=dip_deg)
    m.initialize_workers()
    if grid_spec3d is not None:
        simulate["grid_spec3d"] = grid_spec3d
    if tol is not None:
        simulate["tol"] = tol
    m.simulate_logs(depths, domain_radius=domain_radius, device=device, verbose=False,
                    **simulate)
    return m.logs[tool_name][:, 1]


def main(dips=DIPS, tools=TOOLS, depths=DEPTHS, device="cuda", verbose=False, **fem):
    """FEM against the oracle per tool and dip; returns {dip: worst |FEM /
    oracle - 1| over the tools} and prints a line per (tool, dip). ``fem``
    goes to :func:`fem_log` (``grid_spec3d``, ``domain_radius``, ``dtype``)."""
    worst = {}
    for tool in tools:
        for dip in dips:
            t0 = time.perf_counter()
            f = fem_log(tool, depths, dip, device=device, **fem)
            el = time.perf_counter() - t0
            ana = oracle_log(tool, depths, dip)
            rel = np.abs(f / ana - 1)
            n_nan = int(np.isnan(f).sum())
            worst[dip] = max(worst.get(dip, 0.0), float(np.nanmax(rel)) if n_nan == 0 else np.inf)
            print(f"{tool:>10} dip={dip:2d}: max {np.nanmax(rel) * 100:5.2f}%  "
                  f"mean {np.nanmean(rel) * 100:5.2f}%  nan={n_nan}  ({el:.1f} s)", flush=True)
            if verbose:
                for d, fv, av in zip(depths, f, ana):
                    print(f"    {d:6.2f}  fem {fv:8.3f}  oracle {av:8.3f}  {(fv / av - 1) * 100:+6.2f}%")
    print(f"\nworst deviation across dips and tools: {max(worst.values()) * 100:.2f}%", flush=True)
    return worst


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--dips", default=",".join(map(str, DIPS)))
    ap.add_argument("--tools", default=",".join(TOOLS))
    ap.add_argument("--radius", type=float, default=DOMAIN_RADIUS)
    ap.add_argument("-v", dest="verbose", action="store_true")
    a = ap.parse_args()
    main([int(x) for x in a.dips.split(",")], a.tools.split(","),
         device="cpu" if a.cpu else "cuda", verbose=a.verbose, domain_radius=a.radius)
