"""k3_roofline.2d: readers.k3_roofline in example01_2d.log_full; it moves readouts_per_s.2d."""

from h100_bench.readers import k3_roofline as read  # noqa: F401
