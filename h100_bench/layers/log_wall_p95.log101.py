"""log_wall_p95.log101: readers.wall_p95_untraced in example01_2d.log101 (the nearest-rank p95 of the walls of a --trace 1 window's untraced logs; host clock); it moves readouts_per_s.2d."""

from h100_bench.readers import wall_p95_untraced as read  # noqa: F401
