"""readouts_per_s.ranks4: readouts of every log of example01_2d.ranks4 completed in the window over the window's seconds (host clock, rank 0)."""

from h100_bench.readers import work_per_s as read  # noqa: F401
