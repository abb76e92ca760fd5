# -*- coding: utf-8 -*-
"""Structured boundary-fitted grids: the numpy 2D and 3D host builders and the
torch on-device 2D builder (device_mesh)."""

from .carve import carve_local_model  # noqa: F401
from .grid2d import Grid2D, GridSpec2D, build_grid2d  # noqa: F401
