# -*- coding: utf-8 -*-
"""Hand-written CUDA kernels (sources in ``remo3d_tpu_torch/csrc``), built with
nvcc at first use (:mod:`.build`), each beside its plain torch version."""

# The wrapper modules that count their launches, each registered by its own
# import. A module here has ``LAUNCHES`` (launches run) and ``CAPTURED``
# (launches recorded into a CUDA graph being captured); a graph's replay adds
# its captured launches to ``LAUNCHES`` (``ops/cg.py``).
COUNTED: list = []
