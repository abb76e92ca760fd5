"""readouts_per_s.3d: readouts of every log of bm3_dip30.log_full completed in the window over the window's seconds (host clock)."""

from h100_bench.readers import work_per_s as read  # noqa: F401
