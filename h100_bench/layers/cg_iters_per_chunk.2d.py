"""cg_iters_per_chunk.2d: readers.cg_iters_per_chunk in example01_2d.log_full; it moves readouts_per_s.2d."""

from h100_bench.readers import cg_iters_per_chunk as read  # noqa: F401
