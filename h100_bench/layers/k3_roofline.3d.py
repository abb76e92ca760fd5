"""k3_roofline.3d: readers.k3_roofline in bm3_dip30.log_full; it moves readouts_per_s.3d."""

from h100_bench.readers import k3_roofline as read  # noqa: F401
