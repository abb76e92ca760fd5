# -*- coding: utf-8 -*-
"""Plain-torch numerics: stencil FEM assembly (2D quads, 3D hexes), 9-point
and 27-point applies, the pole projector, PCR line solves, the Galerkin
multigrid V-cycle and batched preconditioned CG.

Counterparts of ``remo3d_tpu.ops`` (the block-direct solvers are still to come).
The hot stencil applies go through the hand-written CUDA kernels in
:mod:`remo3d_tpu_torch.kernels`.
"""

from .assembly2d import assemble_stencil_2d  # noqa: F401
from .cg import pcg  # noqa: F401
from .stencil import stencil_apply, stencil_diag  # noqa: F401
