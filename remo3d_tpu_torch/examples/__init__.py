# -*- coding: utf-8 -*-
"""The JAX package's five examples on the port. Each module runs as
``python -m remo3d_tpu_torch.examples.<name>`` (``--cpu`` for a CPU run; the
default device is "cuda" and needs a card) and exposes a ``main`` whose grid,
depths, dtype and device a test can shrink. Without model files they run the
inline models of :mod:`remo3d_tpu_torch.validation.models`."""
