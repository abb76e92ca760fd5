# -*- coding: utf-8 -*-
"""Invasion zones under a varying caliper, in 2D and 3D (the JAX package's
``benchmarks/bm2_dip_oracle.py``).

Benchmark model 2's invaded beds (FZ radii 0.2 / 0.35 / 0.5 m, FZ 5 ohm-m in
100 ohm-m beds between 10 ohm-m shoulders) under a sinusoidal caliper (0.10
+- 0.015 m, period 15 m) and 1 ohm-m mud. Two gates:

  (a) dip 0: the 2D axisymmetric solver (caliper-following wall) against the
      independent float64 FV oracle with the same varying wall (a staircase
      over ``rw_profile``);
  (b) dip -> 0 (1e-3 deg, which runs the full 3D path): the 3D solver against
      the 2D solver on the same model.

Plus an optional dip-30 run, checked NaN-free (no oracle exists for dipping
beds with invasion and a borehole).

    python -m remo3d_tpu_torch.validation.bm2_dip_oracle [--cpu] [--formation F]
        [--skip-fv] [--dip30]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .fv_oracle import fv_logs
from .models import BM2_FORMATION, BM2_RHO_MUD, formation_table

TOOL = "A2.0M0.5N"
# Shoulder middles, the three invaded-bed middles, one point next to a boundary.
SPOT_DEPTHS = np.array([10.0, 20.0, 30.0, 50.0, 14.5])


def caliper_profile():
    """Sinusoidal caliper: radius 0.10 +- 0.015 m, period 15 m."""
    dept = np.arange(0.0, 60.01, 0.5)
    radius = 0.10 + 0.015 * np.sin(2 * np.pi * dept / 15.0)
    return dept, radius


def fem_log(formation, dip, depths, device="cuda", **simulate):
    """The FEM log of :data:`TOOL` through ``formation`` under the caliper."""
    from ..model import Model

    dept, radius = caliper_profile()
    borehole = np.column_stack([dept, radius, np.full(dept.size, BM2_RHO_MUD)])
    m = Model([TOOL], force_single_electrode_configuration=True)
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius", dip=dip)
    m.initialize_workers()
    m.simulate_logs(np.asarray(depths, dtype=float), device=device, verbose=False, **simulate)
    return m.logs[TOOL][:, 1]


def main(formation=None, depths=SPOT_DEPTHS, device="cuda", skip_fv=False,
         dip30=False, fv=None, grid_spec=None, grid_spec3d=None, **simulate):
    """Runs (a) and (b); returns {"fv_worst": (a)'s worst |2D / FV - 1| (None
    with ``skip_fv``), "gap_max", "gap_mean": (b)'s |3D / 2D - 1|, "nan_dip30"}.
    ``fv`` holds extra arguments of the oracle; ``grid_spec``, ``grid_spec3d``
    and ``simulate`` go to ``Model.simulate_logs``."""
    formation = formation_table(formation, BM2_FORMATION, "BM2-like")
    dept, radius = caliper_profile()
    rw_profile = np.column_stack([dept, radius])
    spec2 = {} if grid_spec is None else {"grid_spec": grid_spec}
    spec3 = {} if grid_spec3d is None else {"grid_spec3d": grid_spec3d}
    out = {"fv_worst": None, "nan_dip30": None}

    t0 = time.perf_counter()
    fem2d = fem_log(formation, 0.0, depths, device, **spec2, **simulate)
    print(f"2D (varying caliper): {np.round(fem2d, 4)}  [{time.perf_counter() - t0:.1f} s]",
          flush=True)
    t0 = time.perf_counter()
    fem3d = fem_log(formation, 1e-3, depths, device, **spec3, **simulate)
    gap = np.abs(fem3d / fem2d - 1)
    out["gap_max"], out["gap_mean"] = float(gap.max()), float(gap.mean())
    print(f"3D dip->0: {np.round(fem3d, 4)}  [{time.perf_counter() - t0:.1f} s]")
    print(f"  (b) 3D vs 2D gap: max {gap.max() * 100:.2f}%  mean {gap.mean() * 100:.2f}%",
          flush=True)

    if not skip_fv:
        jobs = [((TOOL, float(d), formation), {"rw": 0.10, "rho_mud": BM2_RHO_MUD, "subtract": True,
                                           "rw_profile": rw_profile, **(fv or {})})
                for d in depths]
        t0 = time.perf_counter()
        ra_fv, _ = fv_logs(jobs)
        print(f"FV oracle: {len(jobs)} solves in {time.perf_counter() - t0:.1f} s", flush=True)
        rel = fem2d / ra_fv - 1
        for d, f, v, r in zip(depths, fem2d, ra_fv, rel):
            print(f"  (a) z={d:5.1f}: FEM2D {f:9.4f}  FV {v:9.4f}  rel {r:+.3%}", flush=True)
        out["fv_worst"] = float(np.max(np.abs(rel))) if np.isfinite(rel).all() else np.inf
        print(f"  (a) worst 2D vs FV: {out['fv_worst']:.3%}", flush=True)

    if dip30:
        t0 = time.perf_counter()
        fem30 = fem_log(formation, 30.0, depths, device, **spec3, **simulate)
        out["nan_dip30"] = int(np.isnan(fem30).sum())
        print(f"3D dip=30: {np.round(fem30, 4)}  nan={out['nan_dip30']}  "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--formation", default=None)
    ap.add_argument("--skip-fv", action="store_true")
    ap.add_argument("--dip30", action="store_true")
    a = ap.parse_args()
    main(a.formation, device="cpu" if a.cpu else "cuda",
         skip_fv=a.skip_fv, dip30=a.dip30)
