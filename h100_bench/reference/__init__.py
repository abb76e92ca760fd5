"""The benchmark's plain reference: the program's plan, grids and finite
element system worked out again from a configuration in float64, from frozen
copies of the port's host and assembly code taken at commit 214ab07
(``tools``, ``planner``, ``io``, ``carve``, ``grid2d``, ``grid3d``,
``assembly2d``, ``assembly3d``, ``stencil3d``), and solved directly
(:mod:`.solve`). It imports nothing of ``remo3d_tpu_torch``."""
