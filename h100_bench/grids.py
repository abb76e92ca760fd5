# -*- coding: utf-8 -*-
"""Readers of the program's grid counts: how many grids each chunk of a log
built (``Model.last_report["chunks"][i]["grids"]``, the chunk's batches whose
grid this run built; their sum over a log's chunks is ``last_report["grids"]``
on one rank) beside the host seconds that meshing took. A program that
counts no grids gives None."""

from __future__ import annotations


def mesh_s_per_grid(ctx):
    """Host seconds per grid of the traced logs' meshing: their "mesh" and
    "mesh_ahead" phases (``last_report["phases"]``; the caller's builds and
    the read-ahead thread's) over the grids their chunks count."""
    seconds = grids = 0
    for r in ctx["traced"]:
        counts = [c.get("grids") for c in r.get("chunks", ())]
        if not counts or None in counts:
            return None
        grids += sum(counts)
        seconds += r["phases"].get("mesh", 0.0) + r["phases"].get("mesh_ahead", 0.0)
    return seconds / grids if grids else None
