"""log_s_p95.3d: the nearest-rank 95th percentile of the wall of every log of bm3_dip30.log_full in the window (host clock)."""

from h100_bench.readers import wall_p95 as read  # noqa: F401
