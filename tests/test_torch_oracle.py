# -*- coding: utf-8 -*-
"""The port's layered-medium oracle (``remo3d_tpu_torch/utils/layered_oracle.py``)
is a copy of the JAX package's: bit-equal on the inputs of tests/test_oracle.py,
on the axis and off it. And the port's 2D log holds to it as the JAX package's
does (tests/test_oracle.py:74-125): a long lateral over 40 random thin beds with
a negligible borehole, on the 321x65 grid, within 1%."""

import numpy as np
import pytest
import torch

import remo3d_tpu.utils.layered_oracle as joracle
import remo3d_tpu_torch.utils.layered_oracle as toracle
from remo3d_tpu_torch import Model
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D
from remo3d_tpu_torch.tools import parse_tools

torch.set_num_threads(2)

STACK = (np.array([-0.5, 0.0, 0.4, 1.1]), np.array([0.1, 0.5, 0.05, 0.3, 0.2]))


def thin_beds(seed=11):
    """tests/test_oracle.py's stack: 40 random thin beds, 41 resistivities."""
    rng = np.random.default_rng(seed)
    edges = np.cumsum(rng.uniform(0.12, 0.5, 40)) - 4.0
    rho = rng.uniform(1.5, 9.0, 41)
    return edges, rho


@pytest.mark.parametrize("case", ["uniform", "two_halfspaces", "stack", "reciprocity"])
def test_axis_potential_bit_equal(case):
    args = {
        "uniform": (np.array([0.0]), np.array([0.5, 0.5]), -1.0, np.array([1.0, 2.0])),
        "two_halfspaces": (np.array([0.0]), np.array([0.5, 0.1]), -1.0,
                           np.array([-3.0, -0.5, -10.0, 2.0])),
        "stack": (*STACK, -2.0, np.array([3.0, -1.0, 0.2])),
        "reciprocity": (*STACK, 3.0, np.array([-2.0])),
    }[case]
    a = toracle.layered_axis_potential(*args)
    b = joracle.layered_axis_potential(*args)
    np.testing.assert_array_equal(a, b)


def test_off_axis_potentials_bit_equal():
    """The J0 Hankel path (per-source radii) and the batched multi-source solve."""
    kwargs = dict(n_lambda=4000)
    t = toracle.LayeredOracle(np.array([0.0]), np.array([0.5, 0.1]), **kwargs)
    j = joracle.LayeredOracle(np.array([0.0]), np.array([0.5, 0.1]), **kwargs)
    z_src = np.array([-1.0, -0.3])
    z_rec = np.array([-3.0, -0.5, 1.5])
    r = np.array([[0.5, 1.0, 0.7], [2.0, 0.1, 0.3]])
    np.testing.assert_array_equal(t.potentials(z_src, z_rec, r_receivers=r),
                                  j.potentials(z_src, z_rec, r_receivers=r))
    np.testing.assert_array_equal(t.potentials(z_src, z_rec), j.potentials(z_src, z_rec))
    np.testing.assert_array_equal(t._Minv, j._Minv)


def test_apparent_resistivity_bit_equal():
    edges, rho = thin_beds()
    tools, _ = parse_tools(["A4.0M0.5N", "B5.7A0.4M"], True)
    for tp in tools.values():
        offs = np.concatenate([[0.0], tp.geometry[tp.source_terms == 0]])
        for z in (-1.0, 0.0, 1.3):
            a = toracle.layered_apparent_resistivity(edges, rho, offs, tp.geometric_factor, z)
            b = joracle.layered_apparent_resistivity(edges, rho, offs, tp.geometric_factor, z)
            assert a == b


def test_port_log_matches_layered_oracle_long_lateral():
    """tests/test_oracle.py's accuracy statement on the port, on the CPU (the
    block-direct solver; the JAX test runs point-Jacobi CG)."""
    edges, rho = thin_beds()
    formation = np.column_stack([
        np.concatenate([[-1000.0], edges]),
        np.concatenate([edges, [1000.0]]),
        np.full(41, np.nan),
        np.full(41, np.nan),
        rho,
    ])
    borehole = np.array([[-1000.0, 0.002, 4.0], [1000.0, 0.002, 4.0]])
    tool = "A4.0M0.5N"
    tools, _ = parse_tools([tool], True)
    tp = tools[tool]
    depths = np.array([0.0, 1.0])
    m = Model.compute_synthetic_logs(
        [tool], depths, formation, borehole, borehole_geometry_type="radius",
        grid_spec=GridSpec2D(nz=321, nr=65, n_wall_cells=4, n_blend_cells=2),
        device="cpu", preconditioner="direct", verbose=False,
    )
    fem = m.logs[tool][:, 1]
    offs = np.concatenate([[0.0], tp.geometry[tp.source_terms == 0]])
    ana = np.array([
        toracle.layered_apparent_resistivity(edges, rho, offs, tp.geometric_factor,
                                             d + tp.depth_shift)
        for d in depths
    ])
    assert np.all(np.isfinite(fem))
    assert np.max(np.abs(fem / ana - 1)) < 0.01, (fem, ana)
