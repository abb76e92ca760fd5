# -*- coding: utf-8 -*-
"""Example 2: advanced use with optional parameters (the JAX package's
``examples/Example_02.py``): domain radius 25 m, batches of 10, the "netgen"
generator name, and the plot options of ``save_results``. The results files
are read back and held against the log in memory.

    python -m remo3d_tpu_torch.examples.example_02 [--cpu] [--formation F --borehole B]
        [--output DIR]

Without files it runs the inline BM2-like model
(:mod:`remo3d_tpu_torch.validation.models`).
"""

from __future__ import annotations

import time

import numpy as np

from ..model import Model
from ..validation.models import BM2_BOREHOLE, BM2_FORMATION, EXAMPLE01_TOOLS, model_tables
from . import common

DEPTHS = np.arange(0, 25.1, 0.1)
PLOT_OPTIONS = dict(
    plot_layout=[["B5.7A0.4M", "B4.48A1.62M"], ["M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]],
    plot_depth_lim=[0, 25],
    plot_aspect_ratio=1.25,
    model_rad_lim=[-1, 1],
    model_res_lim=[0, 20],
    logs_colours=[["red", "blue"], ["green", "orange", "purple", "deepskyblue"]],
    logs_res_lim=[0, 30],
    logs_at_nan="break",
)


def main(formation=None, borehole=None, output_folder="./Output", tools=EXAMPLE01_TOOLS,
         depths=DEPTHS, device="cuda", **simulate):
    """Run the example; returns (model, results folder). ``simulate`` goes to
    ``Model.compute_synthetic_logs`` (``grid_spec``, ``dtype``, ...)."""
    formation, borehole = model_tables(formation, borehole, BM2_FORMATION,
                                                 BM2_BOREHOLE, "BM2-like")
    before = common.launches()
    t0 = time.perf_counter()
    model = Model.compute_synthetic_logs(
        tools,
        depths,
        formation,
        borehole,
        borehole_geometry_type="radius",
        dip=0,
        cpu_workers=11,
        gpu_workers=0,
        mesh_generator="netgen",
        domain_radius=25,
        batch_size=10,
        device=device,
        **simulate,
    )
    print(f"example 02: {len(depths)} depths x {len(tools)} tools on {device} in "
          f"{time.perf_counter() - t0:.3f} s; launches {common.launches_since(before)}",
          flush=True)
    folder = model.save_results(output_folder=output_folder, **PLOT_OPTIONS)
    print(f"read back: the results files in {folder} agree with the log to "
          f"{common.read_back(folder, model.logs):.1e}", flush=True)
    return model, folder


if __name__ == "__main__":
    args = common.arguments(__doc__.split("\n\n")[0])
    main(args.formation, args.borehole, args.output, device=args.device)
