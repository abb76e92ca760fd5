# -*- coding: utf-8 -*-
"""The port's benchmark entry point, ``python -m remo3d_tpu_torch.bench``, on
the CPU at a tiny size (2D 65x17, 3D 33x9x17, 3 depths each): the one JSON
line with ``bench.py``'s fields, no JAX in any of its processes, the traffic
model against hand counts per route, a child cut at ``--limit``, and no run
on the CPU without ``--cpu``. The bench on the card is ``chip_smoke.py``
phase 29."""

import json
import math
import os
import subprocess
import sys
import time

import pytest

from remo3d_tpu_torch import bench
from remo3d_tpu_torch.kernels import pcr_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--cpu", "--grid-2d", "65x17", "--grid-3d", "33x9x17", "--n-depths", "3"]
BENCH_PY_FIELDS = [
    "metric", "value", "unit", "vs_baseline", "elapsed_3d_s", "n_nan_3d", "phases_3d_s",
    "pts2d_per_s", "solves2d_per_s", "vs_baseline_2d_readouts", "elapsed_2d_s", "n_nan_2d",
    "phases_2d_s", "bw_util_3d", "bw_util_2d",
]


def _bench(args, timeout=300, env=None):
    """Run the bench from the repository's root with two threads per process;
    returns (exit code, stdout, stderr)."""
    env = {**os.environ, "OMP_NUM_THREADS": "2", **(env or {})}
    p = subprocess.run([sys.executable, "-m", "remo3d_tpu_torch.bench", *args], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


@pytest.fixture(scope="module")
def tiny_run():
    """One tiny CPU bench, with every process's imports printed
    (PYTHONPROFILEIMPORTTIME reaches the children too)."""
    return _bench([*TINY, "--repeats", "1"], env={"PYTHONPROFILEIMPORTTIME": "1"})


def test_tiny_cpu_bench_prints_one_line_with_bench_py_fields(tiny_run):
    rc, out, err = tiny_run
    lines = out.splitlines()
    assert rc == 0, err[-3000:]
    assert len(lines) == 1
    line = json.loads(lines[0])
    for field in BENCH_PY_FIELDS + ["runs_3d_s", "runs_2d_s", "device", "model", "layers"]:
        assert field in line, field
    assert line["ok"] is True and line["failures"] == []
    assert line["n_nan_3d"] == 0 and line["n_nan_2d"] == 0
    assert line["unit"] == "points/s" and "3 pts" in line["metric"]
    assert line["device"] == "cpu" and line["model"] == {"3d": "inline", "2d": "inline"}
    assert len(line["runs_3d_s"]) == 1 and len(line["runs_2d_s"]) == 1
    assert line["value"] == pytest.approx(3 / line["elapsed_3d_s"])
    assert line["vs_baseline"] == pytest.approx(line["value"] / bench.REFERENCE_3D_POINTS_PER_S)
    assert line["pts2d_per_s"] == pytest.approx(18 / line["elapsed_2d_s"])
    assert line["spot_3d_rel"] <= bench.SPOT_REL["3d"]
    assert line["spot_2d_rel"] <= bench.SPOT_REL["2d"]
    assert set(line["phases_2d_s"]) >= {"mesh", "stage", "solve", "readout"}


def test_tiny_cpu_bench_writes_no_device_metric(tiny_run):
    line = json.loads(tiny_run[1])
    assert line["bw_util_3d"] is None and line["bw_util_2d"] is None
    for name in ("3d", "2d"):
        layers = line["layers"][name]
        assert layers["busy_share"] is None and layers["top_kernels"] is None
        assert layers["peak_memory_bytes"] is None and layers["profiled_wall_s"] is None
        assert layers["launches"] == {"stencil2d_half": 0, "stencil3d_half": 0, "pcr_lines": 0}
        assert all(0 < k < 1000 for k in layers["cg_iterations"])


def test_tiny_cpu_bench_counts_the_routes_it_took(tiny_run):
    """The CPU's "auto" is the direct chain ("scan") in both dimensions; the
    line's bytes are the direct models' at the chunks and iterations it
    reports."""
    line = json.loads(tiny_run[1])
    l3, l2 = line["layers"]["3d"], line["layers"]["2d"]
    assert l3["route"]["preconditioner"] == "direct" == l2["route"]["preconditioner"]
    assert l3["route"]["direct_schedule"] == "scan"
    assert line["traffic_3d_bytes"] == sum(
        bench.traffic_direct_3d(l3["chunks"]["B"], l3["chunks"]["S"], 33, 9, 17, it,
                                schedule="scan") for it in l3["cg_iterations"])
    assert line["traffic_2d_bytes"] == sum(
        bench.traffic_direct_2d(l2["chunks"]["B"], l2["chunks"]["S"], 65, 17, it,
                                schedule="scan") for it in l2["cg_iterations"])


def test_no_process_of_the_bench_imports_jax(tiny_run):
    imported = set()
    for row in tiny_run[2].splitlines():
        if row.startswith("import time:") and row.count("|") == 2:
            imported.add(row.rsplit("|", 1)[1].strip().split(".")[0])
    assert "remo3d_tpu_torch" in imported and "torch" in imported
    assert not imported & {"jax", "jaxlib", "remo3d_tpu"}


def test_a_workload_past_its_limit_gives_ok_false():
    t0 = time.perf_counter()
    rc, out, err = _bench([*TINY, "--repeats", "1", "--limit", "1"], timeout=120)
    line = json.loads(out.splitlines()[-1])
    assert rc == 1 and line["ok"] is False
    assert [f.split(":")[0] for f in line["failures"]] == ["3d", "2d"]
    assert all("cut at the limit" in f for f in line["failures"])
    assert line["value"] is None and line["elapsed_2d_s"] is None
    assert time.perf_counter() - t0 < 60


def test_runner_ends_the_childs_process_group(capsys):
    """A child cut at its limit leaves no process behind: its own children
    end with it."""
    code = ("import subprocess, sys, time\n"
            "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'])\n"
            "print(p.pid, flush=True)\n"
            "print('{}', flush=True)\n"
            "time.sleep(120)\n")
    run = bench.run_child([sys.executable, "-c", code], 2)
    assert run["status"] == "cut" and run["returncode"] == 124 and run["seconds"] < 15
    pid = int(capsys.readouterr().err.split()[0])  # the lines before the last go to stderr
    for _ in range(50):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        raise AssertionError(f"grandchild {pid} outlived the cut")


def test_without_a_card_the_bench_does_not_run_on_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the bench would run on it")
    rc, out, err = _bench(["--repeats", "1"], timeout=120)
    assert rc != 0 and out == ""
    assert "no CUDA card" in err


# ---- the traffic model against hand counts ------------------------------------------
# Shapes: 2D B=2, S=3 on 5x5 (25 nodes: P = 2*25*4 = 200 bytes a plane,
# V = 600 a vector, 50 mask bytes); 3D B=1, S=2 on 3x3x5 (45 nodes: P = 180,
# V = 360, 45 mask bytes); float32. PCR levels: ceil(log2 n).


def test_traffic_multigrid_2d_hand_count():
    # Levels: 5x5 (K1, 5 planes; PCR 3 levels each way) and 3x3 (9 planes,
    # 2 levels; P = 72, V = 216, 18 mask bytes). Degree 1, coarse degree 2,
    # one power iteration, 3 CG iterations.
    pcr0 = 3 * (1200 + 400) + 1200 + 200  # 6200: per level x, alpha, beta, nxt; x*dinv
    lr0 = 2 * pcr0 + 3 * 600  # both directions, their average: 14200
    a0 = 5 * 200 + 2 * 600  # K1: 2200
    cheb0 = (a0 + 1800 + 50 + lr0) + 3000  # residual, mask, smoother; d and z: 21250
    pcr1 = 2 * (432 + 144) + 432 + 72  # 1656
    a1 = 9 * 72 + 2 * 216  # 1080
    step1 = a1 + 648 + 18 + (2 * pcr1 + 648)  # 5706
    cheb1 = 2 * step1 + 1080 + 1296  # first step d, z (5V); second step d, z (6V): 13788
    vcycle = cheb0 + (a0 + 1800 + 50) + 816 + cheb1 + 816 + (1800 + 50) + cheb0  # 63820
    cg = 2400 + vcycle + 3 * (a0 + 14 * 600 + vcycle) + 600
    # Setup: assembly (coords 2P, 16 cells x 2 x 4 = 128, C 9P), Dirichlet,
    # load (u_s, rhs, lift, C_raw apply, subtraction, mask), u = w + g + u_s.
    load = 2328 + 3650 + (1000 + 1128 + 1250 + 3000 + 1800 + 1250) + 2400
    level0 = 400 + 2 * (8 * 3 + 2) * 200 + 2800 + (2200 + (2 * 3000 + 600) + 800)
    galerkin = 9 * (72 + 200) + 27 * 200 + 9 * (200 + 72) + 18 * 72 + 18 * 72 + 18
    pcr1_p = 2 * (288) + 144 + 72  # the power iteration's PCR on one vector of 72 bytes
    level1 = 144 + 2 * (8 * 2 + 2) * 72 + (792 + (2 * pcr1_p + 216) + 288)
    hand = load + level0 + galerkin + level1 + 2800 + cg
    assert bench.traffic_multigrid_2d(2, 3, 5, 5, 3, n_levels=2, degree=1, coarse_degree=2,
                                      power_iters=1, kernel_levels=1) == hand


def test_traffic_multigrid_2d_hand_count_with_k3():
    """With K3 each PCR apply counts its least bytes in place of the eager
    6200 / 1656 / 3000 / 792 of the hand count above: 2V, and per line the
    coefficients read, alpha_k at i >= s and beta_k at i < n - s, then dinv.
    On 5x5 (k = 3) 5 + 2 (4 + 3 + 1) = 21 values a line, 10 lines of 2 batches
    (840 B): 1200 + 840 = 2040 (vectors) and 400 + 840 = 1240 (the power
    iteration's one plane); on 3x3 (k = 2) 3 + 2 (2 + 1) = 9 values, 6 lines
    (216 B): 432 + 216 = 648 and 144 + 216 = 360. 16 applies per level on
    vectors (4 V-cycles, two line_rz each on level 0, two coarse steps on
    level 1), 2 per level in the power iteration."""
    extra = 16 * (6200 - 2040) + 16 * (1656 - 648) + 2 * (3000 - 1240) + 2 * (792 - 360)
    kw = dict(n_levels=2, degree=1, coarse_degree=2, power_iters=1, kernel_levels=1)
    assert bench.traffic_multigrid_2d(2, 3, 5, 5, 3, pcr_kernel=True, **kw) == (
        bench.traffic_multigrid_2d(2, 3, 5, 5, 3, **kw) - extra)


@pytest.mark.parametrize("schedule", ["bcr", "scan"])
def test_traffic_direct_2d_hand_count(schedule):
    # G: "scan" 5 blocks of 5x5 per batch; "bcr" levels m = 5, 3, 2: (2 + 4)
    # + (1 + 2) + (1 + 1) blocks and the root: 12 blocks. 2 CG iterations.
    blocks = {"scan": 5, "bcr": 12}[schedule]
    G = 2 * blocks * 25 * 4
    # G twice (the root once), b, x; the chain's coupling diagonals.
    apply_ = {"scan": 2 * G + 1200 + 1200, "bcr": 2 * G - 200 + 1200}[schedule]
    cg = 2400 + apply_ + 2 * (2200 + 14 * 600 + apply_) + 600
    load = 2328 + 3650 + 9428 + 2400
    hand = load + 9 * 200 + G + 14 * 200 + cg
    assert bench.direct_factor_bytes_2d(2, 5, 5, schedule=schedule) == G
    assert bench.traffic_direct_2d(2, 3, 5, 5, 2, schedule=schedule) == hand


def _load_3d_hand():
    # Assembly: coords 3P, 2*2*4 cells x 4 = 64, C 27P; Dirichlet; the half
    # planes of C_raw and C (28P each); u_s, rhs, g_lift, the lift (K2 14P +
    # 2V), subtraction, mask, pole tie.
    return (540 + 64 + 4860) + (4860 + 45 + 4860) + 2 * 5040 + (
        (540 + 360) + (540 + 64 + 360) + (360 + 45 + 360) + (2520 + 720) + 1080
        + (720 + 45) + 720)


def test_traffic_adi_3d_hand_count():
    # PCR levels: z 2 (NZ = 3), p 2 (NP = 3), r 3 (NR = 5). 4 CG iterations.
    pcr = {k: k * (720 + 360) + 720 + 180 for k in (2, 3)}  # 3060, 4140
    k2 = 14 * 180 + 2 * 360  # 3240
    sweep = 720 + pcr[2] + 720 + 720  # pole, z solve, pole, damping
    for k in (2, 3, 2, 2):  # p, r, p, z
        sweep += k2 + 1080 + pcr[k] + 720 + 1080
    cg = 1440 + sweep + 4 * (k2 + 14 * 360 + sweep) + 360
    factors = (8 * 2 + 2) * 180 * 2 + (8 * 3 + 2) * 180
    hand = _load_3d_hand() + factors + cg
    assert bench.traffic_adi_3d(1, 2, 3, 3, 5, 4) == hand


def test_traffic_adi_3d_hand_count_with_k3():
    """With K3 the sweep's line solves count 2V = 720 plus the coefficients
    read per line: z and p lines of 3 nodes (k = 2) 3 + 2 (2 + 1) = 9 values,
    15 lines: 1260; r lines of 5 nodes (k = 3) 21 values, 9 lines: 1476; in
    place of 3060 and 4140; five sweeps (one before the loop, one per CG
    iteration) of z, p, r, p, z."""
    extra = 5 * (4 * (3060 - 1260) + (4140 - 1476))
    assert bench.traffic_adi_3d(1, 2, 3, 3, 5, 4, pcr_kernel=True) == (
        bench.traffic_adi_3d(1, 2, 3, 3, 5, 4) - extra)


def test_pcr_kernel_bytes_at_the_main_shapes():
    """K3's least bytes at the main paths' finest shapes (PERF.md's kernel
    table), n (2k + 1) - 2 (2^k - 1) coefficients a line: 2D z lines
    (74,5,761x161) 10 levels 1026.7 MB, r lines 8 levels 864.3 MB; 3D
    (8,5,193x17x49) z 8 levels 125.3 MB, p 5 levels 89.3 MB, r 6 levels 105.1
    MB; the same as the wrapper's least_work, which chip_smoke.py's bounds
    use."""
    p2, p3 = 74 * 761 * 161 * 4, 8 * 193 * 17 * 49 * 4
    g2, g3 = (761, 161), (193, 17, 49)
    for k, n, plane, grid, axis, mb in (
            (10, 761, p2, g2, -2, 1026.7), (8, 161, p2, g2, -1, 864.3), (8, 193, p3, g3, -3, 125.3),
            (5, 17, p3, g3, -2, 89.3), (6, 49, p3, g3, -1, 105.1)):
        got = bench._pcr_apply(k, 5 * plane, plane, n, kernel=True)
        assert got / 1e6 == pytest.approx(mb, abs=0.05)
        batches = plane // (4 * math.prod(grid))
        assert got == pcr_lines.least_work(batches, 5, grid, axis, k, 4)[0]
        assert pcr_lines.coefficient_values(n, k) == n * (2 * k + 1) - 2 * (2**k - 1)


@pytest.mark.parametrize("schedule", ["bcr", "scan"])
def test_traffic_direct_3d_hand_count(schedule):
    # NPR = 15: a block is 15*15*4 = 900 bytes. "scan": 3 blocks. "bcr":
    # level 0 keeps 1 odd block and 9 coupling planes over 2 planes of 15
    # nodes (1080 bytes), then 2 even planes reduce to 1 odd + 1 + 0
    # couplings + the root: 3 blocks. 3 CG iterations.
    G = {"scan": 3 * 900, "bcr": 900 + 1080 + 3 * 900}[schedule]
    # G twice (the root once), b, x, two pole ties; the chain's coupling planes.
    apply_ = {"scan": 2 * G + 720 + 18 * 180 + 1440, "bcr": 2 * G - 900 + 720 + 1440}[schedule]
    cg = 1440 + apply_ + 3 * (3240 + 14 * 360 + apply_) + 360
    hand = _load_3d_hand() + 27 * 180 + G + cg
    assert bench.direct_factor_bytes_3d(1, 3, 3, 5, schedule=schedule) == G
    assert bench.traffic_direct_3d(1, 2, 3, 3, 5, 3, schedule=schedule) == hand


def test_kernel_bytes_at_the_main_shapes():
    """One CG iteration's matvec is the kernels' traffic of PERF.md: K1 at
    (96,5,761,161) 705.7 MB, K2 at (8,5,193,17,49) 123.5 MB."""
    p2 = 96 * 761 * 161 * 4
    assert 5 * p2 + 2 * 5 * p2 == pytest.approx(705.7e6, rel=1e-4)
    per_it_2d = bench.traffic_direct_2d(96, 5, 761, 161, 1) - bench.traffic_direct_2d(
        96, 5, 761, 161, 0)
    apply_2d = 2 * bench.direct_factor_bytes_2d(96, 761, 161) - 96 * 161 * 161 * 4 + 2 * 5 * p2
    assert per_it_2d - apply_2d - 14 * 5 * p2 == 5 * p2 + 2 * 5 * p2
    p3 = 8 * 193 * 17 * 49 * 4
    assert 14 * p3 + 2 * 5 * p3 == pytest.approx(123.5e6, rel=1e-3)
