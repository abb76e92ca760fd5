"""The benchmark of ``remo3d_tpu_torch`` on one NVIDIA H100: ``python3 -m
h100_bench.run`` (see :mod:`h100_bench.run`), driven by ``BENCHMARK.json``
and the data files under this folder."""
