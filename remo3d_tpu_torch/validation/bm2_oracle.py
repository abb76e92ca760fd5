# -*- coding: utf-8 -*-
"""Benchmark model 2 (invasion zones): the FEM log against the independent
float64 finite-volume oracle (the JAX package's ``benchmarks/bm2_oracle.py``).

Three invaded beds (FZ 5 ohm-m to radii 0.2 / 0.35 / 0.5 m, UZ 100 ohm-m)
between 10 ohm-m shoulders, rw = 0.1 m, mud 1 ohm-m. Two tools at 7 spot
depths: the shoulders, the middle of each invaded bed (all three radii) and
two points next to a bed boundary. The oracle (:mod:`.fv_oracle`) solves the
smooth correction to the analytic mud-medium field (``subtract=True``), so
the short normal's readout 0.4 m from the source carries no near-field error.
It runs on the host's CPU, one scipy direct solve per point, spread over the
host's cores (at most 8 processes).

    python -m remo3d_tpu_torch.validation.bm2_oracle [--cpu] [--formation F --borehole B]
        [--tools=A2.0M0.5N,B5.7A0.4M]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .fv_oracle import fv_logs
from .models import BM2_BOREHOLE, BM2_FORMATION, BM2_RHO_MUD, BM2_RW, model_tables

TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]
# Shoulder middle, invaded-bed middles (FZ radius 0.2, 0.35, 0.5), next to a boundary.
SPOT_DEPTHS = [2.5, 10.0, 20.0, 30.0, 50.0, 14.5, 25.5]


def fem_logs(tools, depths, formation, borehole, device="cuda", **simulate):
    """{tool: FEM log at ``depths``} with single-current tools (the oracle
    solves one source); ``borehole`` in radii; ``simulate`` goes to
    ``Model.simulate_logs``."""
    from ..model import Model

    m = Model(list(tools), force_single_electrode_configuration=True)
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
    m.initialize_workers()
    m.simulate_logs(np.asarray(depths, dtype=float), device=device, verbose=False, **simulate)
    return {t: m.logs[t][:, 1] for t in tools}


def main(formation=None, borehole=None, tools=TOOLS, depths=SPOT_DEPTHS, device="cuda",
         fv=None, **simulate):
    """FEM against the oracle at each (tool, depth); returns the worst
    |FEM / FV - 1|. ``fv`` holds extra arguments of the oracle (its grid),
    ``simulate`` those of ``Model.simulate_logs`` (``grid_spec``, ``dtype``)."""
    formation, borehole = model_tables(formation, borehole, BM2_FORMATION, BM2_BOREHOLE,
                                       "BM2-like")
    depths = np.asarray(depths, dtype=float)
    t0 = time.perf_counter()
    fem = fem_logs(tools, depths, formation, borehole, device, **simulate)
    print(f"FEM: {len(depths)} depths x {len(tools)} tools on {device} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    jobs = [((tool, float(d), formation, BM2_RW, BM2_RHO_MUD), {"subtract": True, **(fv or {})})
            for tool in tools for d in depths]
    t0 = time.perf_counter()
    ra_fv, secs = fv_logs(jobs)
    print(f"FV oracle: {len(jobs)} solves in {time.perf_counter() - t0:.1f} s "
          f"({secs.mean():.1f} s each)", flush=True)
    worst, k = 0.0, 0
    for tool in tools:
        for i, d in enumerate(depths):
            rel = fem[tool][i] / ra_fv[k] - 1
            worst = max(worst, abs(rel)) if np.isfinite(rel) else np.inf
            print(f"  {tool:>10} z={d:5.1f}: FEM {fem[tool][i]:9.4f}  FV {ra_fv[k]:9.4f}  "
                  f"rel {rel:+.3%}", flush=True)
            k += 1
    print(f"\nworst |rel| across tools and depths: {worst:.3%}", flush=True)
    return worst


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--formation", default=None)
    ap.add_argument("--borehole", default=None)
    ap.add_argument("--tools", default=",".join(TOOLS))
    a = ap.parse_args()
    main(a.formation, a.borehole, a.tools.split(","), device="cpu" if a.cpu else "cuda")
