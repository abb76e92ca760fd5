"""device_idle.3d: readers.device_idle in bm3_dip30.log_full; it moves readouts_per_s.3d."""

from h100_bench.readers import device_idle as read  # noqa: F401
