# -*- coding: utf-8 -*-
"""Structured boundary-fitted 2D grids: numpy host builders and the torch
on-device builder (device_mesh)."""

from .carve import carve_local_model  # noqa: F401
from .grid2d import Grid2D, GridSpec2D, build_grid2d  # noqa: F401
