# -*- coding: utf-8 -*-
"""The inline models of the port's examples and validation scripts and of
``chip_smoke.py``.

Each script takes a formation and a borehole file as options; without them it
runs the inline model here and says so. The tables use the reference's layout:
formation rows [TOP, BOTTOM, FZ_RADIUS, FZ_VALUE, UZ_VALUE] (m, ohm-m; NaN FZ
columns = no invasion zone), borehole rows [DEPTH, RADIUS, MUD_RESISTIVITY]
(``borehole_geometry_type="radius"``).
"""

from __future__ import annotations

import numpy as np

# Example_01's six tools (normals, laterals and their reciprocals).
EXAMPLE01_TOOLS = ["B5.7A0.4M", "B4.48A1.62M", "M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]

# BM2-like invaded formation: three 10 m beds of 100 ohm-m invaded by a 5 ohm-m
# zone to radii 0.2 / 0.35 / 0.5 m, between 10 ohm-m shoulders (the layout of
# Benchmark model 2: 0.1 m borehole radius, 1 ohm-m mud).
BM2_FORMATION = np.array(
    [
        [-100.0, 5.0, np.nan, np.nan, 10.0],
        [5.0, 15.0, 0.2, 5.0, 100.0],
        [15.0, 25.0, np.nan, np.nan, 10.0],
        [25.0, 35.0, 0.35, 5.0, 100.0],
        [35.0, 45.0, np.nan, np.nan, 10.0],
        [45.0, 55.0, 0.5, 5.0, 100.0],
        [55.0, 200.0, np.nan, np.nan, 10.0],
    ]
)
BM2_BOREHOLE = np.array([[-100.0, 0.1, 1.0], [200.0, 0.1, 1.0]])
BM2_RW, BM2_RHO_MUD = 0.1, 1.0

# BM1-like bed ladder: 100 ohm-m beds of 1, 2, 4 and 8 m between 10 ohm-m
# spacers, no invasion, 0.1 m borehole radius, 1 ohm-m mud. The thicknesses
# are Benchmark model 1's; the positions and resistivities are chosen here,
# not taken from the reference's file.
BM1_FORMATION = np.array(
    [
        [-100.0, 6.0, np.nan, np.nan, 10.0],
        [6.0, 7.0, np.nan, np.nan, 100.0],
        [7.0, 12.0, np.nan, np.nan, 10.0],
        [12.0, 14.0, np.nan, np.nan, 100.0],
        [14.0, 20.0, np.nan, np.nan, 10.0],
        [20.0, 24.0, np.nan, np.nan, 100.0],
        [24.0, 32.0, np.nan, np.nan, 10.0],
        [32.0, 40.0, np.nan, np.nan, 100.0],
        [40.0, 200.0, np.nan, np.nan, 10.0],
    ]
)
BM1_BOREHOLE = np.array([[-100.0, 0.1, 1.0], [200.0, 0.1, 1.0]])
BM1_RW, BM1_RHO_MUD = 0.1, 1.0

# Benchmark model 3: 10 | 100 | 10 ohm-m, the bed crossing the borehole axis
# at 10.77 and 14.23 m (along the axis, whatever the dip); 0.1 m borehole,
# 1 ohm-m mud.
BM3_BOUNDARIES = np.array([10.77, 14.23])
BM3_RHOS = np.array([10.0, 100.0, 10.0])
BM3_FORMATION = np.array(
    [
        [-100.0, 10.77, np.nan, np.nan, 10.0],
        [10.77, 14.23, np.nan, np.nan, 100.0],
        [14.23, 200.0, np.nan, np.nan, 10.0],
    ]
)
BM3_BOREHOLE = np.array([[-100.0, 0.1, 1.0], [200.0, 0.1, 1.0]])

# Example_05's dipping invaded bed (dip 30 deg): 10 ohm-m shoulders, a 100
# ohm-m bed with a 5 ohm-m invasion zone to 0.4 m (4 parameters: UZ of the
# three layers and the bed's FZ).
DIP_BED_FORMATION = np.array(
    [
        [-1000.0, 1.0, np.nan, np.nan, 10.0],
        [1.0, 2.2, 0.4, 5.0, 100.0],
        [2.2, 1000.0, np.nan, np.nan, 10.0],
    ]
)
DIP_BED_BOREHOLE = np.array([[-1000.0, 0.1, 1.0], [1000.0, 0.1, 1.0]])
DIP_BED_DIP = 30.0
DIP_BED_TOOL = "A0.4M0.1N"
DIP_BED_DEPTHS = np.arange(0.4, 2.81, 0.2)  # 13 points through the bed


def formation_table(formation, inline: np.ndarray, name: str) -> np.ndarray:
    """The formation table of a script: the file's if ``formation`` is a path,
    else the inline model ``inline`` (its name printed)."""
    from ..io import load_formation_parameters

    if formation is not None:
        print(f"formation: {formation}", flush=True)
        return load_formation_parameters(formation)
    print(f"formation: the inline {name} model (remo3d_tpu_torch/validation/models.py)",
          flush=True)
    return inline


def model_tables(formation, borehole, inline_formation, inline_borehole, name: str):
    """(formation, borehole) tables of a script's model, the borehole as
    radii: the files loaded (their borehole holds diameters, as the
    reference's files do), or the inline model when neither is given, with a
    line saying which ran. Give both files or neither."""
    from ..io import load_borehole_parameters, load_formation_parameters

    if (formation is None) != (borehole is None):
        raise ValueError("give both a formation and a borehole file, or neither")
    if formation is not None:
        print(f"model files: {formation}, {borehole}", flush=True)
        return load_formation_parameters(formation), load_borehole_parameters(borehole)
    print(f"model: the inline {name} model (remo3d_tpu_torch/validation/models.py)",
          flush=True)
    return inline_formation, inline_borehole
