"""idle_prep_s_per_log.2d: spans.idle_prep_s_per_log in example01_2d.log_full; it moves readouts_per_s.2d."""

from h100_bench.spans import idle_prep_s_per_log as read  # noqa: F401
