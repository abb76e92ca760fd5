# -*- coding: utf-8 -*-
"""Example 4: log inversion with the differentiable forward model (the JAX
package's ``examples/Example_04_inversion.py``).

"Observed" normal and lateral logs are made from a 7-layer formation with 3
invaded beds (10 resistivity parameters), 25 depths on a 193x41 grid; a
Levenberg-Marquardt loop starts from a uniform 10 ohm-m model and recovers
the resistivities with the exact Jacobian of :class:`DifferentiableLog`
(forward and Jacobian are torch tensors). The observations come from the same
grid: the example shows the machinery, not survey design.

    python -m remo3d_tpu_torch.examples.example_04_inversion [--cpu]
        [--formation F --borehole B]

Without files it runs the inline BM2-like model
(:mod:`remo3d_tpu_torch.validation.models`).
"""

from __future__ import annotations

import time

import numpy as np

from ..diff import DifferentiableLog
from ..meshing.grid2d import GridSpec2D
from ..model import Model
from ..validation.models import BM2_BOREHOLE, BM2_FORMATION, model_tables
from . import common

TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]
# 25 measurement points through all 7 layers of the inline model (its beds
# reach 55 m; the JAX example's 0.5..24.5 m cover all of Example_01's).
DEPTHS = np.arange(0.5, 60.6, 2.5)
GRID = GridSpec2D(nz=193, nr=41, n_wall_cells=6, n_blend_cells=3)
START, N_ITER = 10.0, 12


def main(formation=None, borehole=None, depths=DEPTHS, grid_spec=GRID, n_iter=N_ITER,
         device="cuda"):
    """Run the inversion; returns {"worst" (the largest relative parameter
    error), "misfit" (the last rms log-misfit), "iterations", "params",
    "launches", "seconds"}."""
    formation, borehole = model_tables(formation, borehole, BM2_FORMATION, BM2_BOREHOLE,
                                       "BM2-like")
    model = Model(TOOLS)
    model.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
    dlog = DifferentiableLog(model, depths, grid_spec=grid_spec, chunk_size=8, device=device)
    print(f"{len(dlog.params0)} parameters: {dlog.param_names}", flush=True)
    before = common.launches()
    t0 = time.perf_counter()
    p_final, history = common.levenberg_marquardt(dlog, START, n_iter)
    seconds = time.perf_counter() - t0
    worst = common.report_inversion(dlog, p_final)
    counts = common.launches_since(before)
    print(f"example 04: {len(history)} iterations on {device} in {seconds:.3f} s; "
          f"launches {counts}", flush=True)
    return {"worst": worst, "misfit": history[-1]["misfit"], "iterations": len(history),
            "params": p_final, "launches": counts, "seconds": seconds}


if __name__ == "__main__":
    args = common.arguments(__doc__.split("\n\n")[0], output=False)
    main(args.formation, args.borehole, device=args.device)
