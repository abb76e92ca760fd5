# -*- coding: utf-8 -*-
# Frozen copy of remo3d_tpu_torch/io.py at commit 214ab07, for the benchmark's
# reference; the benchmark never imports the program's module.
"""Model file I/O, unit conversion and geometry validation.

File format parity with the reference (remo3d.py:380-514): tab-separated text files
with a names row, a units row, and data rows. Formation columns: TOP, BOTTOM,
FZ_RADIUS, FZ_VALUE, UZ_VALUE. Borehole columns: DEPT, CALM/CALI (diameter or radius),
RM. Allowed units: M, DM, CM, MM, IN, FT (remo3d.py:26).

A numpy copy of ``remo3d_tpu.io``.
"""

from __future__ import annotations

import linecache

import numpy as np

CONVERSION_TABLE = {"M": 1.0, "DM": 0.1, "CM": 0.01, "MM": 0.001, "IN": 0.0254, "FT": 0.3048}


def set_formation_parameters(
    formation_parameters: np.ndarray, formation_units: list[str] = ["M", "M", "M"]
) -> np.ndarray:
    """Convert formation geometry columns to meters and validate.

    Columns: TOP, BOTTOM, FZ_RADIUS, FZ_VALUE (invasion-zone resistivity),
    UZ_VALUE (undisturbed-zone resistivity). Validation parity: contiguous,
    strictly increasing layer boundaries; positive resistivities
    (remo3d.py:424-437).
    """
    formation_parameters = np.array(formation_parameters, dtype=float, copy=True)
    formation_parameters = np.atleast_2d(formation_parameters)
    for i, unit in enumerate(formation_units):
        if unit in CONVERSION_TABLE:
            formation_parameters[:, i] *= CONVERSION_TABLE[unit]
        else:
            raise ValueError(
                f"Unknown length unit {unit!r} in formation model "
                "(allowed: M, DM, CM, MM, IN, FT)"
            )
    if (np.diff(formation_parameters[:, :2], axis=0) <= 0.0).any() or (
        formation_parameters[1:, 0] != formation_parameters[:-1, 1]
    ).any():
        raise ValueError(
            "Invalid formation geometry: layer boundaries must be contiguous "
            "and strictly increasing"
        )
    if np.nanmin(formation_parameters[:, [3, 4]]) <= 0.0:
        raise ValueError("Formation resistivities must be positive (ohmm)")
    return formation_parameters


def load_formation_parameters(formation_model_file: str) -> np.ndarray:
    """Load a formation model TSV (2 header rows; row 2 holds units)."""
    formation_data = np.atleast_2d(np.loadtxt(formation_model_file, delimiter="\t", skiprows=2))
    formation_units = linecache.getline(formation_model_file, 2).split()[:-2]
    return set_formation_parameters(formation_data, formation_units)


def set_borehole_parameters(
    borehole_parameters: np.ndarray,
    borehole_geometry_type: str = "diameter",
    borehole_units: list[str] = ["M", "M"],
) -> np.ndarray:
    """Convert borehole columns to meters, diameters to radii, and validate.

    Columns: DEPT, CALM (diameter or radius), RM (mud resistivity). Validation
    parity: >=2 depths, strictly increasing depths, positive geometry and mud
    resistivity (remo3d.py:492-512).
    """
    borehole_parameters = np.array(borehole_parameters, dtype=float, copy=True)
    borehole_parameters = np.atleast_2d(borehole_parameters)
    if borehole_parameters.shape[0] < 2:
        raise ValueError("The borehole model needs at least two depth stations")
    for i, unit in enumerate(borehole_units):
        if unit in CONVERSION_TABLE:
            borehole_parameters[:, i] *= CONVERSION_TABLE[unit]
        else:
            raise ValueError(
                f"Unknown length unit {unit!r} in borehole model "
                "(allowed: M, DM, CM, MM, IN, FT)"
            )
    if (np.diff(borehole_parameters[:, 0], axis=0) <= 0.0).any() or (
        borehole_parameters[:, 1] <= 0.0
    ).any():
        raise ValueError(
            "Invalid borehole geometry: depths must be strictly increasing and "
            "radii positive"
        )

    if borehole_geometry_type == "diameter":
        borehole_parameters[:, 1] /= 2
    elif borehole_geometry_type == "radius":
        pass
    else:
        raise ValueError(
            f"Unknown borehole geometry type {borehole_geometry_type!r}: "
            "use 'diameter' or 'radius'"
        )
    if np.nanmin(borehole_parameters[:, 2]) <= 0.0:
        raise ValueError("Drilling mud resistivities must be positive (ohmm)")
    return borehole_parameters


def load_borehole_parameters(
    borehole_model_file: str, borehole_geometry_type: str = "diameter"
) -> np.ndarray:
    """Load a borehole model TSV (2 header rows; row 2 holds units)."""
    borehole_data = np.atleast_2d(np.loadtxt(borehole_model_file, delimiter="\t", skiprows=2))
    borehole_units = linecache.getline(borehole_model_file, 2).split()[:-1]
    return set_borehole_parameters(borehole_data, borehole_geometry_type, borehole_units)


def set_dip(dip: float) -> tuple[float, float]:
    """Validate dip (degrees, 0 <= dip < 90) and return (deg, rad)."""
    if dip < 0 or dip >= 90:
        raise ValueError("Dip must satisfy 0 <= dip < 90 degrees")
    return dip, dip * np.pi / 180


def check_model_geometry(formation_model: np.ndarray, borehole_model: np.ndarray) -> None:
    """Borehole radius must stay inside every invasion zone it crosses
    (remo3d.py:540-548; dip=0 semantics)."""
    for i in range(formation_model.shape[0]):
        in_layer = (borehole_model[:, 0] >= formation_model[i, 0]) & (
            borehole_model[:, 0] <= formation_model[i, 1]
        )
        layer_extend = borehole_model[in_layer, 1]
        if np.any(layer_extend >= formation_model[i, 2]):
            raise ValueError(
                "The borehole radius must stay smaller than the invasion-zone "
                "radius at every depth"
            )


def add_points_to_borehole(
    borehole_model: np.ndarray, maximal_distance: float = 0.15
) -> np.ndarray:
    """Densify a sparse borehole polyline by linear interpolation (3D meshing aid;
    remo3d.py:694-720 parity)."""
    depths = [borehole_model[0, 0]]
    for i in range(1, borehole_model.shape[0]):
        distance = borehole_model[i, 0] - borehole_model[i - 1, 0]
        if distance > maximal_distance:
            extra = np.linspace(
                borehole_model[i - 1, 0],
                borehole_model[i, 0],
                max(3, int(distance * 10 + 1)),
            )
            depths.extend(extra[1:])
        else:
            depths.append(borehole_model[i, 0])
    depths = np.asarray(depths)
    if depths.shape[0] <= borehole_model.shape[0]:
        return borehole_model
    radius = np.interp(depths, borehole_model[:, 0], borehole_model[:, 1])
    mud = np.interp(depths, borehole_model[:, 0], borehole_model[:, 2])
    return np.vstack([depths, radius, mud]).T
