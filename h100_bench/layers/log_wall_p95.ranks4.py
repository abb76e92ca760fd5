"""log_wall_p95.ranks4: readers.wall_p95_untraced in example01_2d.ranks4, the nearest-rank 95th percentile of the walls of the window's untraced logs on rank 0 (host clock); it moves readouts_per_s.ranks4."""

from h100_bench.readers import wall_p95_untraced as read  # noqa: F401
