# -*- coding: utf-8 -*-
"""Example 1: basic use (the JAX package's ``examples/Example_01.py``).

Six tools, 251 depths (0..25 m, step 0.1) on the default 761x161 grid with
only the required parameters, then ``save_results``; the results files are
read back and held against the log in memory. Prints the kernels' launches.

    python -m remo3d_tpu_torch.examples.example_01 [--cpu] [--formation F --borehole B]
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


def main(formation=None, borehole=None, output_folder="./Output", tools=EXAMPLE01_TOOLS,
         depths=DEPTHS, device="cuda", **simulate):
    """Run the example; returns (model, results folder). ``simulate`` goes to
    ``Model.compute_synthetic_logs`` (``grid_spec``, ``dtype``, ...)."""
    formation, borehole = model_tables(formation, borehole, BM2_FORMATION,
                                                 BM2_BOREHOLE, "BM2-like")
    before = common.launches()
    t0 = time.perf_counter()
    model = Model.compute_synthetic_logs(
        tools, depths, formation, borehole, borehole_geometry_type="radius", device=device,
        **simulate,
    )
    print(f"example 01: {len(depths)} depths x {len(tools)} tools on {device} in "
          f"{time.perf_counter() - t0:.3f} s; launches {common.launches_since(before)}",
          flush=True)
    folder = model.save_results(output_folder=output_folder)
    print(f"read back: the results files in {folder} agree with the log to "
          f"{common.read_back(folder, model.logs):.1e}", flush=True)
    return model, folder


if __name__ == "__main__":
    args = common.arguments(__doc__.split("\n\n")[0])
    main(args.formation, args.borehole, args.output, device=args.device)
