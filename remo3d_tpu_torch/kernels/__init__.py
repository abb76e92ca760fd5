# -*- coding: utf-8 -*-
"""Hand-written CUDA kernels (sources in ``remo3d_tpu_torch/csrc``), built with
nvcc at first use (:mod:`.build`), each beside its plain torch version."""
