# -*- coding: utf-8 -*-
"""Hand-written CUDA kernels (sources in ``remo3d_tpu_torch/csrc``), built with
nvcc at first use (:mod:`.build`), each beside its plain torch version."""

# The wrapper modules that count their launches, and the counters they keep
# of some of them (``pcr_lines.FUSED``), each registered by its module's
# import. An entry here has ``LAUNCHES`` (launches run) and ``CAPTURED``
# (launches recorded into a CUDA graph being captured); a graph's replay adds
# its captured launches to ``LAUNCHES`` (``ops/cg.py``).
COUNTED: list = []
