# -*- coding: utf-8 -*-
"""The bridge for the state both packages share: numpy arrays -> port tensors.

There are no weights in this system. What crosses from the JAX package to the
port is the formation and borehole tables (numpy, taken by :class:`Model` as
they are) and the per-chunk staged arrays of the chunk solve, which these
helpers turn into the port's tensors so both packages can be fed identical
inputs; and the factorizations of the block-direct solvers, whose layouts are
the same in both packages, so that either package's apply can take the
other's factor; and the staged chunk plan of the differentiable forward
(``DifferentiableLog._stacked``).
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


def chunk_plan_to_torch(stacked, device):
    """The stacked chunk plan of a ``DifferentiableLog`` (a dict of arrays with
    a leading chunk axis, ``remo3d_tpu.diff.DifferentiableLog._stacked`` as
    numpy or JAX arrays, or the port's own) -> a dict of tensors on ``device``,
    as the port's ``DifferentiableLog`` holds them.

    Integer arrays become int64 (torch's gather index type), bool masks stay
    bool, floating arrays float32 (the type the differentiable forward solves
    in, as the JAX package's).
    """
    out = {}
    for name, a in stacked.items():
        a = np.array(a)  # a writable, contiguous copy
        if a.dtype.kind in "iu":
            out[name] = torch.from_numpy(a.astype(np.int64)).to(device)
        elif a.dtype == bool:
            out[name] = torch.from_numpy(a).to(device)
        else:
            out[name] = torch.from_numpy(a).to(device=device, dtype=torch.float32)
    return out


def stencil_to_torch(C, device, dtype):
    """An assembled ``(..., NZ, NR, 3, 3)`` stencil from the JAX package -> tensor."""
    C = np.asarray(C)
    if C.shape[-2:] != (3, 3):
        raise ValueError(f"expected a (..., NZ, NR, 3, 3) stencil, got {C.shape}")
    return torch.tensor(C, device=device).to(dtype)


def factors_to_torch(factors, device, dtype):
    """A factorization of the JAX package's block-direct solvers -> the port's.

    ``factors`` is what a JAX factor function returned, as numpy or JAX arrays
    in the same nesting: the ``(NZ, B, N, N)`` stack of ``block_thomas_factor``
    / ``schur_fixedpoint_factor`` (2D and 3D), the ``(levels, G_root)`` tuple of
    ``bcr_factor``, or the ``(lvl0, dense_factors)`` of ``bcr_factor_3d``.
    Tuples stay tuples and lists lists; every array becomes a ``dtype`` tensor
    on ``device``, as the port's apply of the same name takes it.
    """
    if isinstance(factors, (tuple, list)):
        return type(factors)(factors_to_torch(f, device, dtype) for f in factors)
    return torch.tensor(np.asarray(factors), device=device).to(dtype)


def factors_to_numpy(factors):
    """The port's factorization -> numpy arrays in the same nesting, as the JAX
    package's apply of the same name takes them."""
    if isinstance(factors, (tuple, list)):
        return type(factors)(factors_to_numpy(f) for f in factors)
    return factors.detach().cpu().numpy()
