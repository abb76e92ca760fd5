"""device_idle.ranks4: readers.device_idle_ranks in example01_2d.ranks4; it moves readouts_per_s.ranks4."""

from h100_bench.readers import device_idle_ranks as read  # noqa: F401
