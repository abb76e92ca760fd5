"""plan_s_per_log.ranks4: readers.plan_s_per_log_ranks in example01_2d.ranks4; it moves readouts_per_s.ranks4."""

from h100_bench.readers import plan_s_per_log_ranks as read  # noqa: F401
