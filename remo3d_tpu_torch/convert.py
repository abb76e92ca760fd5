# -*- coding: utf-8 -*-
"""The bridge for the state both packages share: numpy arrays -> port tensors.

There are no weights in this system. What crosses from the JAX package to the
port is the formation and borehole tables (numpy, taken by :class:`Model` as
they are) and the per-chunk staged arrays of the chunk solve, which these
helpers turn into the port's tensors so both packages can be fed identical
inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def chunk_to_torch(arrays, device, dtype):
    """(coords, sigma, free, src_i, src_fac), as ``remo3d_tpu.parallel.runtime.
    _solve_chunk`` takes them, -> the tensors of
    :func:`remo3d_tpu_torch.parallel.runtime._solve_chunk`.

    Floating arrays become ``dtype``, the free mask bool and the source indices
    int64 (torch's gather index type), all on ``device``.
    """
    coords, sigma, free, src_i, src_fac = (np.asarray(a) for a in arrays)

    def put(a, dt):
        return torch.tensor(a, device=device).to(dt)

    return (
        put(coords, dtype),
        put(sigma, dtype),
        put(free, torch.bool),
        put(src_i, torch.int64),
        put(src_fac, dtype),
    )


def stencil_to_torch(C, device, dtype):
    """An assembled ``(..., NZ, NR, 3, 3)`` stencil from the JAX package -> tensor."""
    C = np.asarray(C)
    if C.shape[-2:] != (3, 3):
        raise ValueError(f"expected a (..., NZ, NR, 3, 3) stencil, got {C.shape}")
    return torch.tensor(C, device=device).to(dtype)
