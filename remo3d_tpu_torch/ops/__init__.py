# -*- coding: utf-8 -*-
"""Plain-torch numerics: stencil FEM assembly, 9-point apply, PCR line solves,
the Galerkin multigrid V-cycle and batched preconditioned CG.

Counterparts of ``remo3d_tpu.ops`` (2D only). The hot 9-point apply goes through
the hand-written CUDA kernel in :mod:`remo3d_tpu_torch.kernels.stencil2d`.
"""

from .assembly2d import assemble_stencil_2d  # noqa: F401
from .cg import pcg  # noqa: F401
from .stencil import stencil_apply, stencil_diag  # noqa: F401
