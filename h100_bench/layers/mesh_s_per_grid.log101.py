"""mesh_s_per_grid.log101: grids.mesh_s_per_grid in example01_2d.log101; it moves readouts_per_s.2d."""

from h100_bench.grids import mesh_s_per_grid as read  # noqa: F401
