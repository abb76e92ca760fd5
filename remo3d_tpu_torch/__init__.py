# -*- coding: utf-8 -*-
"""remo3d_tpu_torch: the PyTorch + CUDA port of remo3d_tpu.

Forward modeling of normal and lateral resistivity logs, 2D axisymmetric slice:
the same ``Model`` API as the JAX package, solved with batched multigrid PCG in
torch on one device, with the 9-point stencil apply as a hand-written CUDA
kernel for Hopper (``csrc/stencil2d.cu``). Imports torch and numpy, never JAX.
"""

__version__ = "0.1.0"

from .model import Model  # noqa: F401,E402

__all__ = ["Model"]
