# -*- coding: utf-8 -*-
"""Example 5: inversion of a 3D dipping model (the JAX package's
``examples/Example_05_dip_inversion.py``).

A dipping invaded bed (dip 30, 4 resistivity parameters) logged by one
normal tool at 13 depths; a Levenberg-Marquardt loop starts from a uniform 20
ohm-m model and recovers the resistivities with the exact Jacobian of the 3D
:class:`DifferentiableLog`. The grid is a small 49x7x21 one so that the whole
inversion runs in minutes on a CPU; pass ``grid_spec3d=GridSpec3D()`` for
production resolution. The observations come from the same grid.

    python -m remo3d_tpu_torch.examples.example_05_dip_inversion [--cpu]
"""

from __future__ import annotations

import time

from ..diff import DifferentiableLog
from ..meshing.grid3d import GridSpec3D
from ..model import Model
from ..validation.models import (
    DIP_BED_BOREHOLE,
    DIP_BED_DEPTHS,
    DIP_BED_DIP,
    DIP_BED_FORMATION,
    DIP_BED_TOOL,
)
from . import common

GRID = GridSpec3D(nz=49, np_=7, nr=21, n_wall_cells=3, n_blend_cells=2)
START, N_ITER = 20.0, 15


def main(depths=DIP_BED_DEPTHS, grid_spec3d=GRID, n_iter=N_ITER, device="cuda"):
    """Run the inversion; returns {"worst" (the largest relative parameter
    error), "misfit" (the last rms log-misfit), "iterations", "params",
    "launches", "seconds"}."""
    model = Model([DIP_BED_TOOL])
    model.set_model_parameters(DIP_BED_FORMATION, DIP_BED_BOREHOLE,
                               borehole_geometry_type="radius", dip=DIP_BED_DIP)
    dlog = DifferentiableLog(model, depths, grid_spec3d=grid_spec3d, domain_radius=10.0,
                             chunk_size=4, device=device)
    print(f"dip {DIP_BED_DIP} deg, {len(dlog.params0)} parameters: {dlog.param_names}",
          flush=True)
    before = common.launches()
    t0 = time.perf_counter()
    p_final, history = common.levenberg_marquardt(dlog, START, n_iter)
    seconds = time.perf_counter() - t0
    worst = common.report_inversion(dlog, p_final)
    counts = common.launches_since(before)
    print(f"example 05: {len(history)} iterations on {device} in {seconds:.3f} s; "
          f"launches {counts}", flush=True)
    return {"worst": worst, "misfit": history[-1]["misfit"], "iterations": len(history),
            "params": p_final, "launches": counts, "seconds": seconds}


if __name__ == "__main__":
    main(device=common.arguments(__doc__.split("\n\n")[0], files=False, output=False).device)
