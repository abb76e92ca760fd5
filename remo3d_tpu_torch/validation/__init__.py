# -*- coding: utf-8 -*-
"""Accuracy scripts of the port: the FEM logs against independent oracles
(the float64 finite-volume solve, the rotated layered medium), the float32
spread against float64, and the benchmark-model ladder. Each module runs as
``python -m remo3d_tpu_torch.validation.<name>`` (``--cpu`` for a CPU run; the
default device is "cuda") and exposes a ``main`` a test can shrink."""
