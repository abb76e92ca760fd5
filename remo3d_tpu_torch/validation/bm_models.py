# -*- coding: utf-8 -*-
"""The benchmark-model ladder (the JAX package's ``benchmarks/bm_models.py``),
as smoke and physics checks: every log NaN-free, every chunk's relative
residual at most 1e-5.

* BM1-like: thick 10 / 100 ohm-m beds without invasion; deep inside the
  thick beds the apparent resistivity approaches the bed's.
* BM2-like: invasion zones of radius 0.2 / 0.35 / 0.5 m.
* BM3: the 100 ohm-m bed at dips 0 / 15 / 30 / 45 / 60 (the 3D path; dip 60
  on ``GridSpec3D.high_dip()``), with the dip-15 log against dip 0.

    python -m remo3d_tpu_torch.validation.bm_models [--cpu] [1|2|3]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .models import BM1_BOREHOLE, BM1_FORMATION, BM2_BOREHOLE, BM2_FORMATION, BM3_BOREHOLE
from .models import BM3_FORMATION

TOOLS = ["B5.7A0.4M", "A2.0M0.5N"]
DIPS = (0, 15, 30, 45, 60)
RESIDUAL = 1e-5


def _run(tools, depths, formation, borehole, device, dip=0, **simulate):
    """(model, seconds) of one log, checked NaN-free with every chunk's worst
    relative residual at most :data:`RESIDUAL`."""
    from ..model import Model

    m = Model(tools)
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius", dip=dip)
    m.initialize_workers()
    t0 = time.perf_counter()
    m.simulate_logs(depths, device=device, verbose=False, **simulate)
    seconds = time.perf_counter() - t0
    n_nan = sum(int(np.isnan(v[:, 1]).sum()) for v in m.logs.values())
    residual = max(c["worst_residual"] for c in m.last_report["chunks"])
    if n_nan or not residual <= RESIDUAL:
        raise AssertionError(f"dip {dip}: {n_nan} NaN readouts, worst relative residual "
                             f"{residual:.1e} (limit {RESIDUAL:g})")
    return m, seconds, residual


def run_bm1(device="cuda", depths=np.arange(2.0, 44.01, 0.25), **simulate):
    m, el, res = _run(TOOLS, depths, BM1_FORMATION, BM1_BOREHOLE, device, **simulate)
    print(f"BM1-like: {len(depths)} depths x {len(TOOLS)} tools in {el:.1f} s, worst residual "
          f"{res:.1e}")
    for t in TOOLS:
        log = m.logs[t]
        mid10 = log[np.abs(log[:, 0] - 28.0) < 1.0, 1]  # inside 24-32 (10 ohm-m)
        mid100 = log[np.abs(log[:, 0] - 36.0) < 1.0, 1]  # inside 32-40 (100 ohm-m)
        print(f"  {t:>10}: mid-bed (10 ohm-m) {np.nanmean(mid10):.2f}  mid-bed (100 ohm-m) "
              f"{np.nanmean(mid100):.2f}", flush=True)
    return m.logs


def run_bm2(device="cuda", depths=np.arange(1.0, 19.01, 0.25), **simulate):
    m, el, res = _run(TOOLS, depths, BM2_FORMATION, BM2_BOREHOLE, device, **simulate)
    print(f"BM2-like: {len(depths)} depths x {len(TOOLS)} tools in {el:.1f} s, worst residual "
          f"{res:.1e}")
    for t in TOOLS:
        log = m.logs[t]
        print(f"  {t:>10}: range {np.nanmin(log[:, 1]):.2f}..{np.nanmax(log[:, 1]):.2f}",
              flush=True)
    return m.logs


def run_bm3(device="cuda", depths=np.arange(5.0, 20.01, 0.25), dips=DIPS, **simulate):
    """The dip ladder; returns {dip: log}."""
    results = {}
    for dip in dips:
        m, el, res = _run(["A2.0M0.5N"], depths, BM3_FORMATION, BM3_BOREHOLE, device, dip=dip,
                          **simulate)
        log = m.logs["A2.0M0.5N"]
        results[dip] = log[:, 1]
        print(f"BM3 dip={dip:2d}: {len(depths)} points in {el:.1f} s  range "
              f"{np.nanmin(log[:, 1]):.2f}..{np.nanmax(log[:, 1]):.2f}  nan=0  worst residual "
              f"{res:.1e}", flush=True)
    if 0 in results and 15 in results:
        d = np.nanmean(np.abs(results[15] - results[0]) / np.maximum(results[0], 1e-9))
        print(f"BM3: mean |dip15 - dip0| = {d * 100:.2f}% (expected small)", flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="3", choices=["1", "2", "3"])
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    {"1": run_bm1, "2": run_bm2, "3": run_bm3}[a.which](device="cpu" if a.cpu else "cuda")
