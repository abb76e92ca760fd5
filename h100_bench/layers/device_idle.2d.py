"""device_idle.2d: readers.device_idle in example01_2d.log_full; it moves readouts_per_s.2d."""

from h100_bench.readers import device_idle as read  # noqa: F401
