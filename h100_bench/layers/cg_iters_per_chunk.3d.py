"""cg_iters_per_chunk.3d: readers.cg_iters_per_chunk in bm3_dip30.log_full; it moves readouts_per_s.3d."""

from h100_bench.readers import cg_iters_per_chunk as read  # noqa: F401
