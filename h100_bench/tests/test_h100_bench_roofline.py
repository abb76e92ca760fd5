"""The frozen byte counts against hand counts at the cells' shapes, and the
line-apply and operator-apply counts against the launch counts the program's
kernels showed on the card (PERF.md: K3 72 per V-cycle and 48 in the power
iterations, 984 on a 12-iteration 2D log; K2 and K3 4230 on the 3D log of
CG iterations [284, 285, 274])."""

from h100_bench import roofline as rf

N3 = 193 * 17 * 49
N2 = 761 * 161


def test_k2_bytes_at_the_3d_chunk():
    # 14 half planes of 8 batches and u, y of 40 solves, float32: 123.5 MB
    assert rf.k2_bytes(8, 5, (193, 17, 49), 4) == (14 * 8 + 2 * 40) * N3 * 4 == 123_470_592


def test_k1_bytes_at_the_2d_chunk():
    assert rf.k1_bytes(96, 5, (761, 161), 4) == (5 * 96 + 2 * 480) * N2 * 4


def test_k3_least_bytes_at_the_main_shapes():
    # alpha_k at i >= s, beta_k at i < n - s, dinv: n (2L + 1) - 2 (2^L - 1) a line
    assert rf.coefficient_values(193, 8) == 193 * 17 - 2 * 255
    assert rf.coefficient_values(17, 5) == 17 + 2 * (16 + 15 + 13 + 9 + 1)
    z = rf.least_work(8, 5, (193, 17, 49), 0, 8, 4)[0]
    assert z == 4 * 8 * 17 * 49 * (2 * 5 * 193 + 193 * 17 - 510)
    assert round(z / 1e6, 1) == 125.3
    assert round(rf.least_work(8, 5, (193, 17, 49), 1, 5, 4)[0] / 1e6, 1) == 89.3
    assert round(rf.least_work(8, 5, (193, 17, 49), 2, 6, 4)[0] / 1e6, 1) == 105.1
    assert round(rf.least_work(74, 5, (761, 161), 0, 10, 4)[0] / 1e6, 1) == 1026.7
    assert round(rf.least_work(74, 5, (761, 161), 1, 8, 4)[0] / 1e6, 1) == 864.3


def test_line_apply_counts_match_the_launches():
    per_level = rf.line_applies_multigrid_2d(12, rf.feasible_mg_levels(761, 161))
    solves = sum(2 * count for _, _, count in per_level)  # r and z per line_rz
    assert solves == 984 and rf.feasible_mg_levels(761, 161) == 4
    assert sum(2 * c for _, v, c in rf.line_applies_multigrid_2d(0, 4) if v == 1) == 48
    its = [284, 285, 274]
    assert sum(sum(c for _, c in rf.line_applies_adi_3d(i)) for i in its) == 4230
    assert sum(rf.k2_applies_adi_3d(i) for i in its) == 4230


def test_k3_bytes_sum_the_applies():
    one = rf.k3_bytes_adi_3d(8, 5, (193, 17, 49), 0, 4)
    z, p, r = (rf.least_work(8, 5, (193, 17, 49), a, L, 4)[0] for a, L in ((0, 8), (1, 5), (2, 6)))
    assert one == 2 * z + 2 * p + r
    assert rf.k3_bytes_adi_3d(8, 5, (193, 17, 49), 9, 4) == 10 * one
    two = rf.k3_bytes_multigrid_2d(1, 1, 5, 3, 0, 8)  # two levels: 5x3 and 3x2
    fine = sum(rf.least_work(1, 1, (5, 3), a, rf.n_steps(n), 8)[0] for a, n in ((0, 5), (1, 3)))
    coarse = sum(rf.least_work(1, 1, (3, 2), a, rf.n_steps(n), 8)[0] for a, n in ((0, 3), (1, 2)))
    assert rf.feasible_mg_levels(5, 3) == 2
    assert two == (4 + 6) * fine + (24 + 6) * coarse


def test_traffic_models_at_zero_iterations():
    assert rf.traffic_adi_3d(8, 5, 193, 17, 49, 1, pcr_kernel=True) > rf.traffic_adi_3d(
        8, 5, 193, 17, 49, 0, pcr_kernel=True) > 0
    assert rf.traffic_multigrid_2d(96, 5, 761, 161, 1) > rf.traffic_multigrid_2d(96, 5, 761, 161, 0)
