"""The plain reference at small grids on the CPU: its block solves against a
dense solve, and its logs against the program's float64 logs (the program is
imported by this test only; the reference imports none of it)."""

import numpy as np
import pytest
import torch

from h100_bench.reference import log as ref_log
from h100_bench.reference import solve

BM3 = [[-100.0, 10.77, np.nan, np.nan, 10.0], [10.77, 14.23, np.nan, np.nan, 100.0],
       [14.23, 200.0, np.nan, np.nan, 10.0]]
BM2 = [[-100.0, 5.0, np.nan, np.nan, 10.0], [5.0, 15.0, 0.2, 5.0, 100.0],
       [15.0, 25.0, np.nan, np.nan, 10.0]]
HOLE = [[-100.0, 0.1, 1.0], [200.0, 0.1, 1.0]]


def _dense(blocks, N):
    n = blocks(0)[1].shape[-1]
    A = torch.zeros((blocks(0)[1].shape[0], N * n, N * n), dtype=torch.float64)
    for i in range(N):
        lo, d, up = blocks(i)
        A[:, i * n:(i + 1) * n, i * n:(i + 1) * n] = d
        if i:
            A[:, i * n:(i + 1) * n, (i - 1) * n:i * n] = lo
        if i < N - 1:
            A[:, i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n] = up
    return A


def test_block_thomas_matches_a_dense_solve():
    g = torch.Generator().manual_seed(3)
    B, N, n, S = 2, 5, 4, 3
    lo, up = (torch.randn((B, N, n, n), generator=g, dtype=torch.float64) for _ in range(2))
    d = torch.randn((B, N, n, n), generator=g, dtype=torch.float64) + 8 * torch.eye(n, dtype=torch.float64)
    rhs = torch.randn((B, N, n, S), generator=g, dtype=torch.float64)
    blocks = lambda i: (lo[:, i], d[:, i], up[:, i])  # noqa: E731
    x = solve.block_thomas(blocks, rhs, "float64")
    want = torch.linalg.solve(_dense(blocks, N), rhs.reshape(B, N * n, S))
    torch.testing.assert_close(x.reshape(B, N * n, S), want, rtol=1e-10, atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 3.0e-30, float("inf")])
    y = solve._tf32(x)
    assert y[0] == x[0] and y[1] == 1.0 + 2**-10 and torch.isinf(y[3])


def test_pole_basis_ties_the_axis_copies():
    Q = solve.pole_basis(3, 4, torch.float64, "cpu")
    assert Q.shape == (12, 10) and torch.all(Q.sum(0) == torch.tensor([3.0] + [1.0] * 9))
    assert torch.all(Q[[0, 4, 8], 0] == 1)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_reference_log_matches_the_program_in_float64(dim):
    from remo3d_tpu_torch.meshing.grid2d import GridSpec2D
    from remo3d_tpu_torch.meshing.grid3d import GridSpec3D
    from remo3d_tpu_torch.model import Model

    if dim == "3d":
        grid = dict(nz=33, np_=9, nr=17, n_wall_cells=3, n_blend_cells=2)
        case = ref_log.Case(["A2.0M0.5N"], 9.5 + 0.25 * np.arange(6), np.array(BM3),
                            np.array(HOLE), 30.0, grid)
        kw = {"grid_spec3d": GridSpec3D(**grid)}
    else:
        grid = dict(nz=65, nr=17, n_wall_cells=4, n_blend_cells=2)
        case = ref_log.Case(["B5.7A0.4M", "A2.0M0.5N", "M1.0A0.1B"], 4.0 + 0.1 * np.arange(12),
                            np.array(BM2), np.array(HOLE), 0.0, grid)
        kw = {"grid_spec": GridSpec2D(**grid)}
    model = Model(list(case.tools))
    model.set_model_parameters(case.formation, case.borehole, borehole_geometry_type="radius",
                               dip=case.dip)
    model.simulate_logs(case.depths, device="cpu", dtype="float64", tol=1e-12, verbose=False,
                        **kw)
    prog = np.stack([model.logs[t][:, 1] for t in case.tools], axis=1)
    plan = ref_log.Plan(case)
    ref = ref_log.readouts(plan, range(len(plan.tasks)))
    assert len(ref) == prog.size
    for k, v in ref.items():
        assert abs(prog[k] / v - 1) < 1e-10, (k, prog[k], v)
