# -*- coding: utf-8 -*-
"""Benchmark models 1 and 2: a sweep of the FEM logs against the independent
float64 finite-volume oracle (the JAX package's ``benchmarks/oracle_sweep.py``).

Extends the BM2 spot gate (:mod:`.bm2_oracle`) to many depths through every
bed and boundary region of a BM1-like bed ladder (1 / 2 / 4 / 8 m beds) and
the BM2-like invaded beds, two tools, FEM through the direct preconditioner.
Prints a worst / mean table per model and tool.

    python -m remo3d_tpu_torch.validation.oracle_sweep [--cpu] [--quick]
        [--bm1 FORMATION BOREHOLE] [--bm2 FORMATION BOREHOLE]

``--quick`` takes the first 4 depths of each model. Without files the inline
models of :mod:`.models` run.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .bm2_oracle import fem_logs
from .fv_oracle import fv_logs
from .models import (
    BM1_BOREHOLE,
    BM1_FORMATION,
    BM1_RHO_MUD,
    BM1_RW,
    BM2_BOREHOLE,
    BM2_FORMATION,
    BM2_RHO_MUD,
    BM2_RW,
    model_tables,
)

TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]
# Per model: the inline tables, rw, mud, and depths (shoulders, bed centres,
# points next to a boundary).
SWEEP = {
    "BM1-like": (BM1_FORMATION, BM1_BOREHOLE, BM1_RW, BM1_RHO_MUD,
                 [3.0, 6.5, 9.5, 13.0, 14.5, 17.0, 22.0, 23.5, 28.0, 32.5, 36.0, 45.0]),
    "BM2-like": (BM2_FORMATION, BM2_BOREHOLE, BM2_RW, BM2_RHO_MUD,
                 [2.5, 7.0, 10.0, 13.0, 20.0, 26.0, 30.0, 34.0, 42.0, 50.0, 55.0, 58.0]),
}


def main(quick=False, files=None, tools=TOOLS, device="cuda", fv=None,
         depths=None, **simulate):
    """Sweep both models; returns [(model, tool, worst, mean, n)]. ``files``
    maps a model name to its (formation, borehole) files; ``depths`` to its
    depths (default: the sweep's); ``fv`` and ``simulate`` as in
    :func:`.bm2_oracle.main` (``simulate`` defaults to the direct
    preconditioner)."""
    simulate.setdefault("preconditioner", "direct")
    rows = []
    for name, (inline_f, inline_b, rw, mud, sweep_depths) in SWEEP.items():
        fpath, bpath = (files or {}).get(name, (None, None))
        formation, borehole = model_tables(fpath, bpath, inline_f, inline_b, name)
        zs = np.asarray((depths or {}).get(name, sweep_depths[:4] if quick else sweep_depths),
                        dtype=float)
        t0 = time.perf_counter()
        fem = fem_logs(tools, zs, formation, borehole, device, **simulate)
        fem_s = time.perf_counter() - t0
        jobs = [((tool, float(z), formation), {"rw": rw, "rho_mud": mud, "subtract": True,
                                           **(fv or {})}) for tool in tools for z in zs]
        t0 = time.perf_counter()
        ra_fv, _ = fv_logs(jobs)
        print(f"{name}: FEM {len(zs)} depths x {len(tools)} tools on {device} in {fem_s:.1f} s, "
              f"FV {len(jobs)} solves in {time.perf_counter() - t0:.1f} s", flush=True)
        k = 0
        for tool in tools:
            rels = []
            for i, z in enumerate(zs):
                rel = abs(fem[tool][i] / ra_fv[k] - 1)
                rels.append(rel if np.isfinite(rel) else np.inf)
                print(f"  {name} {tool} z={z:6.2f}: FEM {fem[tool][i]:9.4f} FV {ra_fv[k]:9.4f} "
                      f"rel {rel:.2%}", flush=True)
                k += 1
            rows.append((name, tool, max(rels), float(np.mean(rels)), len(rels)))
    print("\n=== sweep summary (FEM vs the independent float64 FV oracle) ===")
    for name, tool, worst, mean, n in rows:
        print(f"{name:10s} {tool:12s} n={n:2d}  worst {worst:.2%}  mean {mean:.2%}", flush=True)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--bm1", nargs=2, metavar=("FORMATION", "BOREHOLE"))
    ap.add_argument("--bm2", nargs=2, metavar=("FORMATION", "BOREHOLE"))
    a = ap.parse_args()
    files = {k: tuple(v) for k, v in (("BM1-like", a.bm1), ("BM2-like", a.bm2)) if v}
    main(a.quick, files, device="cpu" if a.cpu else "cuda")
