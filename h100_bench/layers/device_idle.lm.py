"""device_idle.lm: readers.device_idle in example01_2d.lm_step; it moves lm_steps_per_s."""

from h100_bench.readers import device_idle as read  # noqa: F401
