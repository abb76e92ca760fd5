"""mesh_s_per_grid.dip60: grids.mesh_s_per_grid in bm2_dip60.log_full; it moves readouts_per_s.3d."""

from h100_bench.grids import mesh_s_per_grid as read  # noqa: F401
