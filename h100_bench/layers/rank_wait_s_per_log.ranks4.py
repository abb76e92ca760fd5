"""rank_wait_s_per_log.ranks4: readers.rank_wait_s_per_log in example01_2d.ranks4; it moves readouts_per_s.ranks4."""

from h100_bench.readers import rank_wait_s_per_log as read  # noqa: F401
