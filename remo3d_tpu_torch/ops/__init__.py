# -*- coding: utf-8 -*-
"""Plain-torch numerics: stencil FEM assembly (2D quads, 3D hexes), 9-point
and 27-point applies, the pole projector, PCR line solves, the Galerkin
multigrid V-cycle, the block-direct solvers (block-LDL^T chain, cyclic
reduction and Schur fixed point, 2D and 3D) and batched preconditioned CG.

Counterparts of ``remo3d_tpu.ops``. The hot stencil applies and the PCR line
solves go through the hand-written CUDA kernels in :mod:`remo3d_tpu_torch.kernels`.
"""

from .assembly2d import assemble_stencil_2d  # noqa: F401
from .block_bcr import bcr_apply, bcr_factor, bcr_factor_dense  # noqa: F401
from .block_bcr3d import bcr_apply_3d, bcr_factor_3d  # noqa: F401
from .block_direct import (  # noqa: F401
    block_thomas_apply,
    block_thomas_factor,
    highest_matmul_precision,
    schur_fixedpoint_factor,
)
from .block_direct3d import (  # noqa: F401
    block_thomas_apply_3d,
    block_thomas_factor_3d,
    schur_fixedpoint_factor_3d,
)
from .cg import pcg  # noqa: F401
from .stencil import stencil_apply, stencil_diag  # noqa: F401
