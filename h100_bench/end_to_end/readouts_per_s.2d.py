"""readouts_per_s.2d: readouts of every log of example01_2d.log_full completed in the window over the window's seconds (host clock)."""

from h100_bench.readers import work_per_s as read  # noqa: F401
