"""k2_roofline: readers.k2_roofline in bm3_dip30.log_full; it moves readouts_per_s.3d."""

from h100_bench.readers import k2_roofline as read  # noqa: F401
