"""idle_cg_s_per_log.3d: spans.idle_cg_s_per_log in bm3_dip30.log_full; it moves readouts_per_s.3d."""

from h100_bench.spans import idle_cg_s_per_log as read  # noqa: F401
