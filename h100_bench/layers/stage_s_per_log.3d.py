"""stage_s_per_log.3d: readers.stage_s_per_log in bm3_dip30.log_full; it moves readouts_per_s.3d."""

from h100_bench.readers import stage_s_per_log as read  # noqa: F401
