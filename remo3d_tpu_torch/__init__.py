# -*- coding: utf-8 -*-
"""remo3d_tpu_torch: the PyTorch + CUDA port of remo3d_tpu.

Forward modeling of normal and lateral resistivity logs: the same ``Model`` API
as the JAX package. Dip 0 runs the 2D axisymmetric solver (batched multigrid
PCG), a dip the 3D dipping-layer solver (ADI line-preconditioned PCG), in torch
on one device per process (several processes split a log over
``parallel.distributed``). The 9-point and 27-point stencil applies are hand-written CUDA
kernels for Hopper (``csrc/stencil2d.cu``, ``csrc/stencil3d.cu``), with their
gradients, and so are the PCR line solves of both preconditioners
(``csrc/pcr_lines.cu``). ``DifferentiableLog`` exposes a log as a differentiable torch
function of the formation resistivities. Imports torch and numpy, never JAX.
"""

__version__ = "0.1.0"

from .diff import DifferentiableLog  # noqa: F401,E402
from .model import Model  # noqa: F401,E402

__all__ = ["DifferentiableLog", "Model"]
