# -*- coding: utf-8 -*-
"""Example 3: a 3D dipping-layer model (the JAX package's
``examples/Example_03_dip.py``): Benchmark model 3 at dip 30, two tools, 61
depths 5..20 m on the default 193x17x49 grid; any nonzero dip selects the 3D
solver. The results files are read back and held against the log in memory.

    python -m remo3d_tpu_torch.examples.example_03_dip [--cpu] [--formation F --borehole B]
        [--output DIR]

Without files it runs the inline BM3 model
(:mod:`remo3d_tpu_torch.validation.models`).
"""

from __future__ import annotations

import time

import numpy as np

from ..model import Model
from ..validation.models import BM3_BOREHOLE, BM3_FORMATION, model_tables
from . import common

TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]
DEPTHS = np.arange(5.0, 20.01, 0.25)
DIP = 30


def main(formation=None, borehole=None, output_folder="./Output", tools=TOOLS, depths=DEPTHS,
         dip=DIP, device="cuda", **simulate):
    """Run the example; returns (model, results folder). ``simulate`` goes to
    ``Model.compute_synthetic_logs`` (``grid_spec3d``, ``dtype``, ...)."""
    formation, borehole = model_tables(formation, borehole, BM3_FORMATION,
                                                 BM3_BOREHOLE, "BM3")
    before = common.launches()
    t0 = time.perf_counter()
    model = Model.compute_synthetic_logs(
        tools, depths, formation, borehole, borehole_geometry_type="radius",
        dip=dip,  # degrees; any nonzero dip selects the 3D solver
        device=device, **simulate,
    )
    print(f"example 03: dip {dip}, {len(depths)} depths x {len(tools)} tools on {device} in "
          f"{time.perf_counter() - t0:.3f} s; launches {common.launches_since(before)}",
          flush=True)
    folder = model.save_results(output_folder=output_folder)
    print(f"read back: the results files in {folder} agree with the log to "
          f"{common.read_back(folder, model.logs):.1e}", flush=True)
    return model, folder


if __name__ == "__main__":
    args = common.arguments(__doc__.split("\n\n")[0])
    main(args.formation, args.borehole, args.output, device=args.device)
