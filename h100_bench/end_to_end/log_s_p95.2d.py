"""log_s_p95.2d: the nearest-rank 95th percentile of the wall of every log of example01_2d.log_full in the window (host clock)."""

from h100_bench.readers import wall_p95 as read  # noqa: F401
