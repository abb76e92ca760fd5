#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke test of the PyTorch port (remo3d_tpu_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, nvcc and the checkout's own sources, imports nothing of JAX, and fails
(non-zero exit, no result line) when any of them is missing or any phase fails:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: nvcc builds the kernel library from ``remo3d_tpu_torch/csrc``; per
   kernel and shape, the registers, shared memory, tile height and resident
   blocks per SM that the CUDA runtime reports;
3. kernel K1 (``stencil2d_half``) against its plain torch version on the card,
   float32 and float64, at the 2D path's two multigrid shapes, an edge case
   and a ragged shape (NZ no multiple of the tile height, NR no multiple of
   4), then both timed with CUDA events beside the bound and a CSR sparse
   product;
4. the 2D main path at full width: ``Model.compute_synthetic_logs`` on
   ``cuda``, 6 tools x 101 depths on the default 761x161 grid, with the kernels'
   launch counts read around the run and the CG loop's graph captures and
   replays (``ops/cg.py``); the same log with the CG loop op by op
   (:func:`eager`), whose readouts, CG iterations and launches must equal the
   graphed run's (:func:`graph_vs_eager`); then the same log with the kernels
   off;
5. 2D cross-check: 3 depths on the card and on the CPU (plain versions) agree;
6. 2D physics: in a uniform medium every tool reads the true resistivity;
7. kernel K2 (``stencil3d_half``) against its plain version, float32 and
   float64, with the pole tie off and on (on: also against the kernel between
   two ``pole_project`` calls), at the 3D path's chunk shape, the ``high_dip``
   grid, an edge case, a ragged shape and one lower than a tile, then timed
   like K1;
8. the 3D main path at full width: the 100-point Benchmark-model-3 log at dip
   30 on the default 193x17x49 grid, with the launch counts read around it,
   then again with the CG loop op by op, held to it as in phase 4;
9. the first 20 depths of that log again with the kernels off;
10. 3D cross-check in float64: 3 depths on the card and on the CPU agree;
11. 3D physics: a uniform medium at dip 30 reads the true resistivity;
12. the 2D preconditioner screen: the log of phase 4 through multigrid,
    ``preconditioner="direct"`` with ``direct_schedule`` "bcr" and "scan", the
    same three again in reverse order, and "fp" on the first 10 depths beside a
    multigrid run of those; every direct log agrees with a float64 direct log
    and with the multigrid one, has no failed solve and launched K1; wall,
    solve and factor seconds, CG iterations, launches, the CG graphs and peak
    memory per run; the second run of each preconditioner runs its CG loop op
    by op and is held to the first as in phase 4;
13. the same screen in 3D: the log of phase 8 through "adi" and
    ``precond3d="direct"`` ("bcr", "scan"; "fp" on the first 10 depths), K2's
    launches;
14. float64 direct cross-check, 2D and 3D, "scan" and "bcr": 3 depths on the
    card and on the CPU agree;
15. the TF32 guard: with TF32 products switched on by the caller, the direct
    factor and apply give the same result as with them off, and the caller's
    setting is unchanged afterwards;
16. K1 and K2 under autograd: the gradients of a random projection of each
    kernel's output (``grad_u``, ``grad_C_half``) against autograd of the plain
    versions at the main shapes (K2 with and without the pole tie) and a
    ragged one, ``torch.autograd.gradcheck`` (reverse and forward mode) in
    float64 at tiny shapes, the kernel output's ``grad_fn``, and the time of
    the coefficient contraction beside its bound;
17. the 2D differentiable forward at full width: ``DifferentiableLog`` of this
    script's formation (10 parameters), two tools, 25 depths on the default
    761x161 grid in chunks of 8, against the card's direct-preconditioned
    ``Model`` log; reverse mode against forward mode (the Jacobian), central
    finite differences on the two most sensitive parameters; K1's launches
    counted around the forward, the backward and the Jacobian; the first
    forward and Jacobian and one more taped forward and backward with the CG
    loops op by op, held to the graphed calls as in phase 4;
18. the same in 3D: a dipping invaded bed (dip 30, 4 parameters), 13 depths on
    the default 193x17x49 grid, against the card's ``precond3d="direct"`` log;
    K2's launches; graphed against op by op;
19. the card against the CPU (forward and Jacobian of the 2D log on a 193x41
    grid), then a Levenberg-Marquardt inversion of the 3D log on a 49x7x21
    grid, which must recover the 4 resistivities;
20. the native mesher: its grids against the numpy builders' at 761x161 (2D),
    193x17x49 at dip 30 and the ``high_dip`` grid at dip 60, then the
    100-point 3D log of phase 8 meshed natively and with numpy (readouts
    agree, mesh seconds of both);
21. the layered oracle: a long lateral over 40 random thin beds, 21 depths on
    the default grid, against the semi-analytic layered-medium solution;
22. checkpoint: the log of phase 4 in 4 chunks, broken after its second chunk,
    resumed (only the 2 missing chunks are solved, the log equals an unbroken
    run), then run again (no chunk is solved);
23. ``profile_dir``: the first 10 depths of the 2D and 3D logs traced, each
    trace naming its kernel;
24. two ranks over gloo on the one card: the log of phase 4 split on the batch
    axis, a 4-depth 3D log of one batch split on the solve axis, both against
    the single-process logs; and a rank at world size 1, bitwise equal to no
    process group;
25. the float32 spread on the card (``validation.arithmetic_parity``): the
    log of phase 4 in float32 (multigrid) against float64 (direct, tol
    1e-10), held to the JAX package's spread of the same workload; the BM3
    dip-30 (ra3d) and the axis-potential (u2d) spreads beside its figures;
26. the examples (``remo3d_tpu_torch.examples``) through their ``main``:
    Example_01 (6 tools x 251 depths on 761x161), Example_02's options,
    Example_03 (BM3 at dip 30), whose results files are read back, and the
    inversions of Example_04 (2D, 10 parameters) and Example_05 (3D), which
    must recover every resistivity within 0.1%;
27. the oracle scripts (``remo3d_tpu_torch.validation``): BM3 at dips
    15-60 against the rotated layered medium, and the BM2-like spot depths,
    the BM1-like / BM2-like sweep (``--quick``) and the BM2-like invaded beds
    under a varying caliper against the float64 finite-volume oracle (scipy,
    on the host's cores), each beside the JAX package's README figure;
28. float64 potentials on the card against the finite-volume oracle at one
    BM1-like source depth, the 1x / 2x / 4x refinement ladder's observed
    order, and the BM3 dip ladder 0-60 NaN-free within its residual bound;
30. kernel K3 (``pcr_lines``, the factored PCR line apply) against its plain
    version, float32 and float64, at every line shape of phases 4 and 8
    (each multigrid level of the 2D log in r and z, with and without the
    solve axis; the 3D chunk's z, p and r lines), each timed against its
    bound and the plain version, with registers, shared memory, resident
    blocks per SM and the tile plan (lines per tile, cluster, segment,
    coefficient stages); and the 3D ADI sweep's damped step at both 3D
    benchmark cells' chunks, per line direction: K3 with its step epilogue
    (in place) and the axis tie against K3 and the step's torch ops,
    bit-equal off the axis column, each timed;
31. phase 4's 2D log with K3 off, on, on with the CG loop op by op, and off
    again (``ops.lines.PCR_KERNEL``): K3 on against off within LOG_REL, CG
    iterations per chunk within 1, K3 launched in every CG iteration with it
    on and never with it off; graphed against op by op as in phase 4;
32. the same for phase 8's 3D log, within LOG3D_REL_PAIR.
The launch counts of K1, K2 and K3 are read around every script of 25-28.

Every phase group (3-6, 7-11, 12-15, 16-19, 20-24, 25-28, 30-32) runs in a
child process (``python3 chip_smoke.py --phase <group>``) under ``timeout -k
10 <limit>``
(:data:`GROUP_LIMITS`, about three times the group's time on an H100), so a
hung launch fails the run with a printed line instead of blocking it; the
parent builds the kernels once before the first group. Each child's last line
is a JSON object with its results, from which the parent assembles the
kernels line. The line before the last is a JSON object with one entry per
kernel; the last is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --screen`` instead runs phases 12-15 alone,
``python3 chip_smoke.py --diff`` phases 16-19 and ``python3 chip_smoke.py
--k3`` phases 30-32 (``--phase 25-28`` runs one group as a child would).
``python3 chip_smoke.py --profile-direct`` instead profiles one warm direct
log per dimension and exact schedule ("bcr", "scan"): wall, busy share, the
factorization's seconds and the ten device activities that take most time.
``python3 chip_smoke.py --tune-direct`` instead times ``torch.linalg.inv`` at
the direct solvers' block shapes and the 3D factorizations per ``z_block``.
``python3 chip_smoke.py --tune`` instead times K1 and K2 at their main
shapes for every tile height, to choose the kernels' automatic one, and K3
at every line shape of both logs, float32 and float64, for the tile plans of
least estimated cost and others (how its cost model was fitted).
``python3 chip_smoke.py --probe`` instead times K2 beside its probe builds
(``REMO3D_K2_PROBE`` in ``csrc/stencil3d.cu``: without the mirrored coefficient
loads, without any coefficient load, without the sum over shared memory) and
K3 beside its own (``REMO3D_K3_PROBE`` in ``csrc/pcr_lines.cu``: without any
coefficient loaded, without the barrier between levels), to say what their
time is spent on. Every mode runs in a child under its limit.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The inline models (the BM2-like invaded formation, Benchmark model 3,
# Example_05's dipping bed) live in remo3d_tpu_torch/validation/models.py.
from remo3d_tpu_torch.validation.models import BM2_BOREHOLE as BOREHOLE  # noqa: E402
from remo3d_tpu_torch.validation.models import BM2_FORMATION as FORMATION  # noqa: E402
from remo3d_tpu_torch.validation.models import (  # noqa: E402
    BM3_BOREHOLE,
    BM3_FORMATION,
    EXAMPLE01_TOOLS,
)
from remo3d_tpu_torch.validation.models import DIP_BED_BOREHOLE as DIFF_BOREHOLE_3D  # noqa: E402
from remo3d_tpu_torch.validation.models import DIP_BED_DEPTHS as DIFF_DEPTHS_3D  # noqa: E402
from remo3d_tpu_torch.validation.models import DIP_BED_FORMATION as DIFF_FORMATION_3D  # noqa: E402
from remo3d_tpu_torch.validation.models import DIP_BED_TOOL as DIFF_TOOL_3D  # noqa: E402

DEPTHS = np.arange(0.0, 10.01, 0.1)
KERNEL_SHAPES = [(96, 5, 761, 161), (96, 5, 381, 81), (1, 2, 7, 5), (2, 3, 37, 23)]
TOOLS_3D = ["A2.0M0.5N"]
DEPTHS_3D = np.arange(5.0, 29.76, 0.25)  # 100 measurement points
DIP = 30
KERNEL3D_SHAPES = [
    (8, 5, 193, 17, 49), (2, 5, 257, 25, 65), (1, 2, 6, 3, 5), (2, 3, 11, 5, 7), (1, 2, 3, 3, 5),
]
# The kernels vs their plain versions, relative to max|y|: one summation order,
# but the kernels contract multiply-adds into FMAs.
TOL_REL = {"float32": 1e-5, "float64": 1e-12}
# K2 with the pole tie against K2 between two pole_project calls: the same
# arithmetic but for the order of the mean over the NP azimuth copies.
TOL_POLE = {"float32": 1e-6, "float64": 1e-13}
# The CSR sparse product (cuSPARSE) sums in its own order.
TOL_LIBRARY = 1e-4
# One float32 log at tol 3e-7 sits within 2.2e-4 of its float64 solve (README,
# "Solver arithmetic"). The CPU cross-check is held to 2e-4; two float32 runs
# on the card that differ only in summation order to twice the 2.2e-4.
LOG_REL = 2e-4
LOG_REL_PAIR = 4.4e-4
# 3D: two float32 CG solves at tol 1e-5 that differ in summation order; the
# float64 card-vs-CPU pair at tol 1e-10; the uniform-medium identity.
LOG3D_REL_PAIR = 1e-3
LOG3D_REL_F64 = 1e-8
UNIFORM3D_REL = 1e-3
# A float32 direct-preconditioned log against the float64 direct log of the
# same plan (tol 1e-10, so meshing, assembly and load are float64 too): on the
# 761x161 grid the float32 multigrid log itself sits 1.15e-4 from it (tool
# M4.0A0.5B; the others 4.6e-5 to 7.1e-5) and the direct logs 1.13e-4 to
# 1.17e-4, measured on an H100 (5.6e-4 to 6.2e-4 before the port's float32 2D
# operator closed its zero row sums and K1 took the difference form; the JAX
# package's float32 log of this workload sits up to 3.19e-4 from its float64
# one). Against the float32 multigrid (2D) or "adi" (3D) log, which carries
# its own such spread: 6e-4 in 2D, LOG3D_REL_PAIR in 3D.
LOG64_REL = 1e-3
DIRECT_REL = {"2D": (LOG64_REL, 6e-4), "3D": (LOG64_REL, LOG3D_REL_PAIR)}
# CG iterations per chunk under an exact direct factor ("scan", "bcr"): 3-4
# measured on an H100 at full width. A factor that has gone wrong still lets CG
# converge, in tens of iterations, so the count is the check on the factor.
DIRECT_MAX_ITERATIONS = 8
# float64 direct logs, card against CPU, at tol 1e-12 (2D) and 1e-10 (3D).
DIRECT_F64_REL = 1e-8
# Depths of the "fp" runs (the truncated factor takes hundreds of CG
# iterations, each with two NZ-step sweeps), and its pass counts.
N_FP_DEPTHS = 10
FP_PASSES = {"2D": 32, "3D": 8}
# The differentiable forward (phases 17-19). 2D: this script's formation, the
# tools and depths of examples/Example_04_inversion.py; 3D: the dipping invaded
# bed of examples/Example_05_dip_inversion.py.
DIFF_TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]
DIFF_DEPTHS = np.arange(0.5, 24.6, 1.0)
# The JAX package's own bounds (tests/test_diff.py): forward against the
# direct-preconditioned Model log 5e-4 (2D) and 1e-4 (3D), reverse against
# forward mode 2e-3 of scale, finite differences 5% (2D) and 1% (3D); card
# against CPU 2e-4 (forward) and 2e-3 of scale (Jacobian).
DIFF_FORWARD_REL = {"2D": 5e-4, "3D": 1e-4}
DIFF_REV_FWD = 2e-3
DIFF_FD = {"2D": 0.05, "3D": 0.01}
DIFF_CPU_REL, DIFF_CPU_JAC = 2e-4, 2e-3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 / float64 flop/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# The rest of the package (phases 20-24). Native against numpy grids: the JAX
# package's limits (tests/test_grid.py). The two 3D logs (grids within 1e-11)
# are float32 CG solves stopped at tol 1e-5, which the grids' rounding moves
# by about that tolerance (1.8e-5 on an H100): held to ten times it.
NATIVE_COORD_ATOL, NATIVE_SIGMA3D_RTOL, NATIVE_LOG_REL = 1e-10, 1e-9, 1e-4
# tests/test_oracle.py's thin-bed stack and tool; its bound, 1%.
ORACLE_TOOL, ORACLE_DEPTHS, ORACLE_REL = "A4.0M0.5N", np.linspace(-2.0, 2.0, 21), 0.01
# Phase 22: chunks of 24 batches cut phase 4's 74 batches into 4 chunks; a
# resumed log repeats the unbroken run's arithmetic chunk by chunk.
CKPT_CHUNK, CKPT_BREAK_AT, CKPT_REL = 24, 3, 1e-6
# Phase 24: split logs against the single-process ones, in float64: a float32
# CG stopped at tol 1e-5 whose reductions sum in another order (another chunk
# shape) moves a readout by about the tolerance (1.0e-5 on the CPU for the
# 3D log split on the solve axis), in float64 by nothing visible.
RANKS_REL, RANKS_DTYPE = 1e-5, "float64"
DEPTHS_RANKS_3D = DEPTHS_3D[:4]

# Phases 25-28: the examples and validation scripts. Phase 25 holds phase 4's float32 log to the
# JAX package's float32-vs-float64 spread of the same workload (CPU,
# tests/test_torch_spread.py run as a script): max 3.19e-4, rms 9.403e-5.
C2_MAX, C2_RMS = 3.19e-4, 9.403e-5
# The inversions of examples 04 and 05: every resistivity within 0.1%.
INVERSION_WORST, INVERSION_MISFIT = 1e-3, 1e-4
# Phase 27: the oracle scripts. bm3_oracle per dip (dip 60 on high_dip);
# bm2_oracle and oracle_sweep; bm2_dip_oracle 2D vs FV and 3D at dip->0 vs 2D.
BM3_ORACLE_REL = {15: 5e-3, 30: 5e-3, 45: 5e-3, 60: 6e-3}
FV_ORACLE_REL = 5e-3
BM2_DIP_FV_REL, BM2_DIP_GAP = 5e-3, 0.03
# Phase 28: float64 potentials against the FV oracle; the refinement ladder's
# observed order (2 for Q1 elements).
POTENTIAL_FV_REL, ORDER_RANGE = 1e-2, (1.8, 2.3)
# The JAX package's README figures, printed beside the port's: the float32
# spreads (3D Ra; 2D axis potentials max / mean) and bm3_oracle's worst
# (over dips 15-45 on the default grid; dip 60 on high_dip).
JAX_RA3D, JAX_U2D = 1.1e-4, (6.9e-5, 2.4e-5)
JAX_BM3 = {15: "0.43% over dips 15-45", 30: "0.43% over dips 15-45",
           45: "0.43% over dips 15-45", 60: "0.50%"}

# Time limit (s) of each phase group's child: about three times the group's
# time on an H100 80GB HBM3 at 700 W (3-6 and 7-11 ~25 s each, 12-15 ~150-230
# s, 16-19 ~55-70 s, 20-24 ~90-105 s, 25-28 ~180-215 s, 30-32 ~35 s) plus the
# child's start.
GROUP_LIMITS = {
    "3-6": 180, "7-11": 180, "12-15": 700, "16-19": 300, "20-24": 420, "25-28": 540,
    "30-32": 240, "profile-direct": 1800, "tune-direct": 600, "tune": 600, "probe": 600,
}
GROUPS = ["3-6", "7-11", "12-15", "16-19", "20-24", "25-28", "30-32"]
# Phase 30: K3 at the line shapes of phase 4's 2D log (its chunk of 74
# batches of 5 solves on 761x161 and the multigrid's coarser levels) and of
# phase 8's 3D chunk.
K3_2D_BS, K3_2D_GRID = (74, 5), (761, 161)
K3_3D_SHAPE = (8, 5, 193, 17, 49)
# The five line shapes on which the main paths spend K3's time (float32).
MAIN_K3_SHAPES = ("2D level 0 z", "2D level 0 r", "3D z", "3D p", "3D r")
MODES = {"--screen": "12-15", "--diff": "16-19", "--k3": "30-32",
         "--profile-direct": "profile-direct", "--tune-direct": "tune-direct",
         "--tune": "tune", "--probe": "probe"}


def log(msg: str) -> None:
    print(msg, flush=True)


_ACTIVE_GROUPS: set[int] = set()  # process groups of the children running now


def _end_children(signum, frame):
    """SIGTERM (a limit reached this process): end the children it runs first."""
    import signal

    for pgid in list(_ACTIVE_GROUPS):
        try:
            os.killpg(pgid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    os._exit(128 + signum)


def run_child(argv: list[str], limit_s: float, env: dict | None = None, echo: bool = True) -> dict:
    """Run ``argv`` under ``timeout -k 10 <limit_s>`` and wait for it.

    The child's standard output is echoed line by line (``echo``), its
    standard error passes through. Returns {"status": "ok" | "cut" | "failed",
    "returncode", "seconds", "result" (the last output line parsed as JSON, or
    None), "tail" (the last 40 output lines)}. "cut" means the limit ended the
    child (exit 124, or 137 after the kill 10 s later); timeout signals the
    child's whole process group, so the processes it started end too. A
    watchdog kills the group should timeout itself fail to. Imports neither
    torch nor jax, so a CPU test can drive it."""
    import collections
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        ["timeout", "-k", "10", str(limit_s), *argv], stdout=subprocess.PIPE, text=True,
        env=env, start_new_session=True,
    )

    def kill_group():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    _ACTIVE_GROUPS.add(proc.pid)
    watchdog = threading.Timer(limit_s + 30, kill_group)
    watchdog.start()
    tail = collections.deque(maxlen=40)
    held = []  # the last non-empty line and the blank ones after it
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            tail.append(line)
            if line.strip():
                if echo:
                    for h in held:
                        print(h, flush=True)
                held = [line]
            else:
                held.append(line)
        proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            kill_group()
            proc.wait()
        _ACTIVE_GROUPS.discard(proc.pid)
    seconds = time.perf_counter() - t0
    result = None
    try:
        result = json.loads(held[0]) if held else None
    except json.JSONDecodeError:
        if echo:
            print(held[0], flush=True)
    rc = proc.returncode
    status = "ok" if rc == 0 and isinstance(result, dict) else (
        "cut" if rc in (124, 137, -9) else "failed")
    return {"status": status, "returncode": rc, "seconds": seconds, "result": result,
            "tail": list(tail)}


def random_symmetric_stencil_2d(rng, B, NZ, NR):
    """Random 9-point stencil with FEM symmetry C[n, d] == C[n+d, -d] and zero
    coupling across the grid boundary (float64, (B, NZ, NR, 3, 3))."""
    C = np.zeros((B, NZ, NR, 3, 3))
    C[..., 1, 1] = 10.0 + rng.random((B, NZ, NR))
    for dz, dr in [(0, 1), (1, -1), (1, 0), (1, 1)]:
        h = rng.standard_normal((B, NZ, NR))
        src = [slice(None)] * 3
        dst = [slice(None)] * 3
        for ax, d, n in ((1, dz, NZ), (2, dr, NR)):
            if d > 0:
                src[ax], dst[ax] = slice(0, n - d), slice(d, n)
            elif d < 0:
                src[ax], dst[ax] = slice(-d, n), slice(0, n + d)
        mask = np.zeros((B, NZ, NR), dtype=bool)
        mask[tuple(src)] = True
        h *= mask
        C[..., 1 + dz, 1 + dr] = h
        hm = np.zeros_like(h)
        hm[tuple(dst)] = h[tuple(src)]
        C[..., 1 - dz, 1 - dr] = hm
    return C


def random_symmetric_stencil_3d(rng, B, NZ, NP, NR):
    """Random 27-point stencil with FEM symmetry C[n, d] == C[n+d, -d] and zero
    coupling across the grid boundary (float64, (B, NZ, NP, NR, 27); after
    tests/test_pallas.py)."""

    def entry(dz, dp, dr):
        return ((dz + 1) * 3 + (dp + 1)) * 3 + (dr + 1)

    C = np.zeros((B, NZ, NP, NR, 27))
    C[..., entry(0, 0, 0)] = 10.0 + rng.random((B, NZ, NP, NR))
    offsets = [
        (dz, dp, dr)
        for dz in (-1, 0, 1)
        for dp in (-1, 0, 1)
        for dr in (-1, 0, 1)
        if (dz, dp, dr) > (0, 0, 0)
    ]
    for dz, dp, dr in offsets:
        h = rng.standard_normal((B, NZ, NP, NR))
        src = [slice(None)] * 4
        dst = [slice(None)] * 4
        for ax, d, n in ((1, dz, NZ), (2, dp, NP), (3, dr, NR)):
            if d > 0:
                src[ax], dst[ax] = slice(0, n - d), slice(d, n)
            elif d < 0:
                src[ax], dst[ax] = slice(-d, n), slice(0, n + d)
        mask = np.zeros((B, NZ, NP, NR), dtype=bool)
        mask[tuple(src)] = True
        h *= mask
        C[..., entry(dz, dp, dr)] = h
        hm = np.zeros_like(h)
        hm[tuple(dst)] = h[tuple(src)]
        C[..., entry(-dz, -dp, -dr)] = hm
    return C


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Device time (ms) of one call of ``fn``, with CUDA events.

    The events and the call are queued behind a device-side sleep (~1 ms), so
    the card starts the call only once the host has issued all of it: the
    host's launch latency does not count as device time."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bound_ms(n_bytes: float, flops: float, dtype: str):
    """The least time (ms) the card could take: the larger of the bytes over
    the HBM rate and the flops over the peak rate; and which of the two."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stencil_csr(torch, C_flat, offsets):
    """Block-diagonal CSR matrix of a full-storage stencil.

    C_flat (B, *grid, E) with entry e coupling node n to n + offsets[e]; the
    matrix is (B*N, B*N), so one ``torch.sparse.mm`` applies every batch."""
    B, grid, dev = C_flat.shape[0], tuple(C_flat.shape[1:-1]), C_flat.device
    N = math.prod(grid)
    strides = [math.prod(grid[i + 1 :]) for i in range(len(grid))]
    pos = torch.meshgrid(*[torch.arange(n, device=dev) for n in grid], indexing="ij")
    node = torch.arange(N, device=dev).reshape(grid)
    base = (torch.arange(B, device=dev) * N)[:, None]
    rows, cols, vals = [], [], []
    for e, off in enumerate(offsets):
        ok = torch.ones(grid, dtype=torch.bool, device=dev)
        for p, o, n in zip(pos, off, grid):
            ok &= (p + o >= 0) & (p + o < n)
        n_idx = node[ok]
        shift = sum(o * s for o, s in zip(off, strides))
        rows.append((base + n_idx[None]).reshape(-1))
        cols.append((base + n_idx[None] + shift).reshape(-1))
        vals.append(C_flat[..., e][:, ok].reshape(-1))
    with warnings.catch_warnings():  # sparse CSR is "beta" in torch
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals), (B * N, B * N)
        )
        return A.coalesce().to_sparse_csr()


def check_and_time(torch, label, shapes, make, plain_fn, kernel_fn, half_fn, n_half, flops_per_out,
                   also=None):
    """Phases 3 and 7: a kernel against its plain version at every shape, f32
    and f64; at the first (main-path) shape also timed against its plain
    version and a CSR sparse product, 25 interleaved calls each.

    ``make(rng, shape)`` -> (full-storage C flattened to (B, *grid, E), the
    offsets of its E entries, full C as the half-plane builder takes it).
    ``also(C_half, u, name, shape)``, if given, makes further checks at every
    shape and type and returns {key: fn} of further calls to time at the main
    shape. Returns {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
    "library_ms", *keys} at the main shape, float32."""
    rng = np.random.default_rng(2024)
    out = {}
    for shape in shapes:
        B, S = shape[:2]
        n_nodes = math.prod(shape[2:])
        C_flat64, offsets, C_full64 = make(rng, shape)
        u64 = rng.standard_normal(shape)
        for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            C_half = half_fn(torch.as_tensor(C_full64, device="cuda").to(dt))
            u = torch.as_tensor(u64, device="cuda").to(dt)
            y_k = kernel_fn(C_half, u)
            y_p = plain_fn(C_half, u)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            rel = err / float(y_p.abs().max())
            log(
                f"{label} {name} {shape}: max|kernel-plain| = {err:.3e}, relative to max|y| "
                f"{rel:.3e} (tolerance {TOL_REL[name]:g})"
            )
            if not rel <= TOL_REL[name]:
                raise AssertionError(f"{label} {name} {shape}: rel err {rel:.3e} > {TOL_REL[name]}")
            more = also(C_half, u, name, shape) if also else {}
            if name == "float32" and shape == shapes[0]:
                A = stencil_csr(torch, torch.as_tensor(C_flat64, device="cuda").to(dt), offsets)
                U = u.reshape(B, S, n_nodes).transpose(1, 2).reshape(B * n_nodes, S).contiguous()
                y_l = torch.sparse.mm(A, U).reshape(B, n_nodes, S).transpose(1, 2)
                rel_l = float((y_l - y_p.reshape(B, S, n_nodes)).abs().max()) / float(y_p.abs().max())
                log(f"{label} float32 {shape}: CSR sparse product vs plain, relative {rel_l:.3e}")
                if not rel_l <= TOL_LIBRARY:
                    raise AssertionError(f"{label}: sparse product rel err {rel_l:.3e}")
                for _ in range(3):  # warm-up
                    kernel_fn(C_half, u)
                    plain_fn(C_half, u)
                    torch.sparse.mm(A, U)
                    for fn in more.values():
                        fn()
                k_ms, p_ms, l_ms = [], [], []
                more_ms = {key: [] for key in more}
                for _ in range(25):  # interleaved: plain, kernel, library, the further calls
                    p_ms.append(time_ms(torch, lambda: plain_fn(C_half, u)))
                    k_ms.append(time_ms(torch, lambda: kernel_fn(C_half, u)))
                    l_ms.append(time_ms(torch, lambda: torch.sparse.mm(A, U)))
                    for key, fn in more.items():
                        more_ms[key].append(time_ms(torch, fn))
                k, p, lib = (float(np.median(v)) for v in (k_ms, p_ms, l_ms))
                n_bytes = 4.0 * n_nodes * B * (n_half + 2 * S)
                b_ms, b_by = bound_ms(n_bytes, flops_per_out * n_nodes * B * S, name)
                log(
                    f"{label} float32 {shape}: kernel {k:.4f} ms, plain {p:.4f} ms, CSR sparse "
                    f"product {lib:.4f} ms (median of 25); bound {b_ms:.4f} ms by {b_by} "
                    f"({n_bytes / 1e6:.1f} MB at 3.35 TB/s): kernel at {b_ms / k:.1%} of it, "
                    f"{n_bytes / (k * 1e-3) / 1e9:.0f} GB/s"
                )
                out = {"max_abs_err": err, "ms": k, "plain_ms": p, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": lib}
                for key, v in more_ms.items():
                    out[key] = float(np.median(v))
                    log(f"{label} float32 {shape}: {key} {out[key]:.4f} ms (median of 25), "
                        f"{out[key] / k - 1:+.1%} on the kernel")
                del A, U, y_l
            del C_half, u, y_k, y_p, more
    torch.cuda.empty_cache()
    return out


def check_k1(torch):
    """Phase 3: K1 against its plain version, then timed at the main shapes."""
    from remo3d_tpu_torch.kernels import stencil2d

    def make(rng, shape):
        B, _, nz, nr = shape
        C = random_symmetric_stencil_2d(rng, B, nz, nr)
        offsets = [(di - 1, dj - 1) for di in range(3) for dj in range(3)]
        return C.reshape(B, nz, nr, 9), offsets, C

    return check_and_time(
        torch, "K1", KERNEL_SHAPES, make, stencil2d.stencil_apply_half_2d_plain,
        stencil2d.stencil_apply_half_2d, stencil2d.half_planes_2d, 5, 25,
    )


def check_k2(torch):
    """Phase 7: K2 against its plain version, then timed at the chunk shape."""
    from remo3d_tpu_torch.kernels import stencil3d
    from remo3d_tpu_torch.ops.stencil3d import pole_project

    def make(rng, shape):
        B, _, nz, np_, nr = shape
        C = random_symmetric_stencil_3d(rng, B, nz, np_, nr)
        offsets = [(dz, dp, dr) for dz in (-1, 0, 1) for dp in (-1, 0, 1) for dr in (-1, 0, 1)]
        return C, offsets, C

    def with_pole(C_half, u, name, shape):
        """K2 with the pole tie: against its plain version and against the
        kernel between two pole_project calls; u must come out untouched."""
        u_before = u.clone()
        y_k = stencil3d.stencil3d_apply_half(C_half, u, pole=True)
        y_p = stencil3d.stencil3d_apply_half_plain(C_half, u, pole=True)
        y_c = pole_project(stencil3d.stencil3d_apply_half(C_half, pole_project(u)))
        torch.cuda.synchronize()
        scale = float(y_p.abs().max())
        rel_p = float((y_k - y_p).abs().max()) / scale
        rel_c = float((y_k - y_c).abs().max()) / scale
        log(
            f"K2 {name} {shape} pole tie: kernel vs plain {rel_p:.3e} (tolerance "
            f"{TOL_REL[name]:g}), vs pole_project(kernel(pole_project(u))) {rel_c:.3e} "
            f"(tolerance {TOL_POLE[name]:g}), relative to max|y|"
        )
        if not (rel_p <= TOL_REL[name] and rel_c <= TOL_POLE[name]):
            raise AssertionError(f"K2 {name} {shape} pole tie: {rel_p:.3e}, {rel_c:.3e}")
        if not torch.equal(u, u_before):
            raise AssertionError(f"K2 {name} {shape}: the pole tie modified u")
        return {
            "pole_ms": lambda: stencil3d.stencil3d_apply_half(C_half, u, pole=True),
            "pole_unfused_ms": lambda: pole_project(
                stencil3d.stencil3d_apply_half(C_half, pole_project(u))),
        }

    return check_and_time(
        torch, "K2", KERNEL3D_SHAPES, make, stencil3d.stencil3d_apply_half_plain,
        stencil3d.stencil3d_apply_half, stencil3d.half_planes_3d, 14, 54, also=with_pole,
    )


def report_kernel_info(torch):
    """Phase 2: what the built kernels use at the paths' shapes."""
    from remo3d_tpu_torch.kernels import stencil2d, stencil3d

    rows = {}
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        for shape in KERNEL_SHAPES[:2]:
            rows[f"K1 {name} S={shape[1]} NR={shape[3]}"] = stencil2d.kernel_info(
                shape[1], shape[3], dt)
        for shape in KERNEL3D_SHAPES[:2]:
            rows[f"K2 {name} S={shape[1]} NPxNR={shape[3]}x{shape[4]}"] = stencil3d.kernel_info(
                shape[1], shape[3], shape[4], dt)
    for key, info in rows.items():
        log(
            f"{key}: {info['registers']} registers, {info['spill_bytes']} B spilled, "
            f"{info['smem_bytes']} B shared memory per block, TZ = {info['tile_rows']}, "
            f"{info['solves_per_group']} solves per group, {info['blocks_per_sm']} blocks of 256 "
            f"threads resident per SM"
        )
        if info["blocks_per_sm"] < 1:
            raise AssertionError(f"{key}: no block fits an SM")
    return rows


def tune(torch, card):
    """K1 and K2 at their main shapes, float32, for every tile height: 15
    interleaved rounds over the heights, median per height; then K3's plans
    (:func:`tune_k3`)."""
    from remo3d_tpu_torch.kernels import stencil2d, stencil3d

    rng = np.random.default_rng(2024)
    sweeps = (
        ("K1", stencil2d, KERNEL_SHAPES[0], (4, 8, 12, 16, 20, 24, 32, 40),
         lambda B, *g: random_symmetric_stencil_2d(rng, B, *g), stencil2d.half_planes_2d,
         {"": lambda C, u, tz: stencil2d.stencil_apply_half_2d(C, u, tile_rows=tz)}),
        ("K2", stencil3d, KERNEL3D_SHAPES[0], (1, 2, 3, 4, 5, 6, 8),
         lambda B, *g: random_symmetric_stencil_3d(rng, B, *g), stencil3d.half_planes_3d,
         {"": lambda C, u, tz: stencil3d.stencil3d_apply_half(C, u, tile_rows=tz),
          " pole": lambda C, u, tz: stencil3d.stencil3d_apply_half(C, u, pole=True,
                                                                    tile_rows=tz)}),
    )
    for label, mod, shape, heights, make, half_fn, fns in sweeps:
        B, S = shape[:2]
        C_half = half_fn(torch.as_tensor(make(B, *shape[2:]), device="cuda").float())
        u = torch.as_tensor(rng.standard_normal(shape), device="cuda").float()
        times = {(tz, key): [] for tz in (0, *heights) for key in fns}
        for rnd in range(16):  # round 0 warms up
            for tz in (0, *heights):
                for key, fn in fns.items():
                    t = time_ms(torch, lambda: fn(C_half, u, tz))
                    if rnd:
                        times[(tz, key)].append(t)
        for tz in (0, *heights):
            info = mod.kernel_info(S, *shape[3:], tile_rows=tz)
            log(
                f"tune {label} {shape} on {card}: TZ {'auto' if tz == 0 else tz} "
                f"(runs with {info['tile_rows']}, {info['smem_bytes']} B, "
                f"{info['blocks_per_sm']} blocks/SM): "
                + ", ".join(f"kernel{key} {float(np.median(times[(tz, key)])):.4f} ms"
                            for key in fns)
            )
        del C_half, u
        torch.cuda.empty_cache()
    tune_k3(torch, card)


def reset_counts():
    from remo3d_tpu_torch.kernels import pcr_lines, stencil2d, stencil3d

    stencil2d.LAUNCHES = 0
    stencil3d.LAUNCHES = 0
    pcr_lines.LAUNCHES = 0


def read_counts():
    from remo3d_tpu_torch.kernels import pcr_lines, stencil2d, stencil3d

    return {"stencil2d_half": stencil2d.LAUNCHES, "stencil3d_half": stencil3d.LAUNCHES,
            "pcr_lines": pcr_lines.LAUNCHES}


def kernel_dicts() -> dict:
    """One empty dict per kernel of :func:`read_counts`, for launch counts."""
    return {"stencil2d_half": {}, "stencil3d_half": {}, "pcr_lines": {}}


# Graphed CG loops (ops/cg.py: every iteration after the first is a replay of
# one captured CUDA graph) against the same loops op by op: the same
# operations on the same inputs in the same order, so the readouts should be
# bit-equal. A difference is printed with its size and held to this gate
# (relative); CG iterations and kernel launches must be equal.
GRAPH_REL = 1e-6


def eager(fn):
    """``fn()`` with ops/cg.py's CUDA graphs off: every CG iteration op by op."""
    from remo3d_tpu_torch.ops import cg

    cg.GRAPHS = False
    try:
        return fn()
    finally:
        cg.GRAPHS = True


def graph_figures(report) -> str:
    """The CG graphs of a log: capture seconds (summed) and replays per chunk."""
    chunks = report["chunks"]
    return (f"CG graph capture {sum(c['capture_seconds'] for c in chunks):.4f} s, replays "
            f"{[c['replays'] for c in chunks]}")


def graph_vs_eager(label, graphed, op_by_op) -> list[str]:
    """Prints the graphed run against the op-by-op one; each a dict with
    "vals" (readouts), "iterations" and "launches". Returns the faults."""
    g, e = np.asarray(graphed["vals"]), np.asarray(op_by_op["vals"])
    differ = ~((g == e) | (np.isnan(g) & np.isnan(e)))
    rel = float(np.nanmax(np.abs(g / e - 1), initial=0.0))
    same = "bit-equal" if not differ.any() else (
        f"{int(differ.sum())} of {g.size} differ, max rel {rel:.3e} (gate {GRAPH_REL:g})")
    log(f"graph vs eager, {label}: readouts {same}; CG iterations {graphed['iterations']} / "
        f"{op_by_op['iterations']}; launches {graphed['launches']} / {op_by_op['launches']}")
    faults = []
    if g.shape != e.shape or (np.isnan(g) != np.isnan(e)).any() or not rel <= GRAPH_REL:
        faults.append(f"{label}: graphed vs eager readouts {same}")
    if graphed["iterations"] != op_by_op["iterations"]:
        faults.append(f"{label}: CG iterations {graphed['iterations']} graphed, "
                      f"{op_by_op['iterations']} eager")
    if graphed["launches"] != op_by_op["launches"]:
        faults.append(f"{label}: launches {graphed['launches']} graphed, "
                      f"{op_by_op['launches']} eager")
    return faults


def eager_twin(torch, make_log, readouts):
    """The log ``make_log()`` again with the graphs off, counted like the main
    path: {"vals", "iterations", "launches", "wall"}."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = eager(make_log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"vals": readouts(model), "launches": read_counts(), "wall": wall,
            "iterations": [c["iterations"] for c in model.last_report["chunks"]]}


def log_3d(torch, depths, **kwargs):
    from remo3d_tpu_torch import Model

    return Model.compute_synthetic_logs(
        TOOLS_3D, depths, BM3_FORMATION, BM3_BOREHOLE, borehole_geometry_type="radius",
        dip=DIP, verbose=False, **kwargs,
    )


def run_2d(torch, card):
    """Phases 4-6; returns the K1 and K3 launch counts of the main-path run."""
    from remo3d_tpu_torch import Model
    from remo3d_tpu_torch.plotting import _write_tsv_groups

    kwargs = dict(
        borehole_geometry_type="radius", domain_radius=50, batch_size=5,
        dtype="float32", device="cuda", verbose=False,
    )
    def make_log():
        return Model.compute_synthetic_logs(EXAMPLE01_TOOLS, DEPTHS, FORMATION, BOREHOLE,
                                            **kwargs)

    def readouts(model):
        return np.stack([model.logs[t][:, 1] for t in EXAMPLE01_TOOLS], axis=1)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = make_log()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["stencil2d_half"]
    report = model.last_report
    chunks = report["chunks"]
    iters = [c["iterations"] for c in chunks]
    n_solves = sum(c["solves"] for c in chunks)
    vals = np.stack([model.logs[t][:, 1] for t in EXAMPLE01_TOOLS], axis=1)
    log(
        f"2D main path on {card}: {len(DEPTHS)} depths x {len(EXAMPLE01_TOOLS)} tools, "
        f"{n_solves} solves in {len(chunks)} chunks of B={report['chunk']} "
        f"(S={report['n_solve_slots']}), CG iterations {iters}"
    )
    log(
        f"2D main path on {card}: {elapsed:.3f} s, {n_solves / elapsed:.2f} solves/s, "
        f"{vals.size / elapsed:.2f} readouts/s; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in report["phases"].items())
        + f"; launches {counts}; {graph_figures(report)}"
    )
    if not np.isfinite(vals).all():
        raise AssertionError(f"{int((~np.isfinite(vals)).sum())} non-finite readouts")
    if report["n_failed_solves"] != 0:
        raise AssertionError(f"{report['n_failed_solves']} failed solves")
    if not all(0 < k < 1000 for k in iters):
        raise AssertionError(f"CG iterations {iters} (maxiter 1000)")
    if launches < 2 * sum(iters) or counts["pcr_lines"] < 2 * sum(iters):
        raise AssertionError(f"K1 / K3 launched {launches} / {counts['pcr_lines']} times for CG "
                             f"iterations {iters}")
    if not all(c["replays"] == c["iterations"] - 1 for c in chunks):
        raise AssertionError(f"2D: CG graph replays {graph_figures(report)} for iterations {iters}")
    twin = eager_twin(torch, make_log, readouts)
    log(f"2D main path on {card} with the CG loop op by op: {twin['wall']:.3f} s")
    faults = graph_vs_eager("2D log (phase 4)", {"vals": vals, "iterations": iters,
                                                 "launches": counts}, twin)
    if faults:
        raise AssertionError("; ".join(faults))

    with tempfile.TemporaryDirectory() as tmp:
        _write_tsv_groups(model.logs, "auto", tmp)
        path = os.path.join(tmp, "Results_1.txt")
        with open(path) as f:
            head = [f.readline().rstrip("\n") for _ in range(2)]
        table = np.loadtxt(path, skiprows=2, delimiter="\t")
    if head[0].split("\t") != ["DEPTH"] + EXAMPLE01_TOOLS or table.shape != (len(DEPTHS), 7):
        raise AssertionError(f"Results_1.txt: header {head}, table {table.shape}")
    log(f"Results_1.txt parses: {table.shape[0]} rows x {table.shape[1]} columns")

    t0 = time.perf_counter()
    plain = Model.compute_synthetic_logs(
        EXAMPLE01_TOOLS, DEPTHS, FORMATION, BOREHOLE,
        executor_overrides={"use_stencil_kernel": False}, **kwargs,
    )
    plain_elapsed = time.perf_counter() - t0
    pvals = np.stack([plain.logs[t][:, 1] for t in EXAMPLE01_TOOLS], axis=1)
    rel_plain = float(np.max(np.abs(pvals / vals - 1)))
    log("  per tool: " + ", ".join(
        f"{t} {float(np.max(np.abs(pvals[:, i] / vals[:, i] - 1))):.1e}"
        for i, t in enumerate(EXAMPLE01_TOOLS)))
    log(
        f"2D main path on {card} with the plain 9-point apply: {plain_elapsed:.3f} s "
        f"({n_solves / plain_elapsed:.2f} solves/s); readouts agree with the kernel "
        f"run to {rel_plain:.2e}"
    )
    if not rel_plain <= LOG_REL_PAIR:
        raise AssertionError(f"kernel vs plain log: rel diff {rel_plain:.2e} > {LOG_REL_PAIR}")

    # ---- 5. cross-check against the CPU ----------------------------------------------
    sub = DEPTHS[[20, 50, 80]]
    same_mesh = {"device_meshing": True, "preconditioner": "multigrid"}
    runs = {}
    for device in ("cuda", "cpu"):
        m = Model.compute_synthetic_logs(
            EXAMPLE01_TOOLS, sub, FORMATION, BOREHOLE,
            executor_overrides=same_mesh, **{**kwargs, "device": device},
        )
        runs[device] = np.stack([m.logs[t][:, 1] for t in EXAMPLE01_TOOLS], axis=1)
    rel_cpu = float(np.max(np.abs(runs["cuda"] / runs["cpu"] - 1)))
    log("  per tool: " + ", ".join(
        f"{t} {float(np.max(np.abs(runs['cuda'][:, i] / runs['cpu'][:, i] - 1))):.1e}"
        for i, t in enumerate(EXAMPLE01_TOOLS)))
    rel_full = float(np.max(np.abs(runs["cuda"] / vals[[20, 50, 80]] - 1)))
    log(
        f"2D cross-check at depths {sub.tolist()}: cuda vs cpu max rel diff {rel_cpu:.2e}; "
        f"(vs the 101-depth log, whose batches mesh around other centres: {rel_full:.2e})"
    )
    if not (np.isfinite(runs["cpu"]).all() and rel_cpu <= LOG_REL):
        raise AssertionError(f"cuda vs cpu: rel diff {rel_cpu:.2e} > {LOG_REL}")

    # ---- 6. uniform medium -------------------------------------------------------------
    rho = 10.0
    uniform = Model.compute_synthetic_logs(
        EXAMPLE01_TOOLS, DEPTHS[[0, 50, 100]],
        np.array([[-100.0, 200.0, np.nan, np.nan, rho]]),
        np.array([[-100.0, 0.1, rho], [200.0, 0.1, rho]]),
        **kwargs,
    )
    worst_u = max(float(np.max(np.abs(v[:, 1] / rho - 1))) for v in uniform.logs.values())
    log(f"2D uniform medium {rho} ohm-m: worst |Ra/Rt - 1| = {worst_u:.2e}")
    if not worst_u <= 5e-3:
        raise AssertionError(f"uniform medium: |Ra/Rt - 1| = {worst_u:.2e} > 5e-3")
    return launches, counts["pcr_lines"]


def run_3d(torch, card):
    """Phases 8-11; returns the K2 and K3 launch counts of the main-path run."""
    from remo3d_tpu_torch.meshing.grid3d import GridSpec3D

    cuda32 = dict(device="cuda", dtype="float32")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = log_3d(torch, DEPTHS_3D, **cuda32)
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["stencil3d_half"]
    report = model.last_report
    chunks = report["chunks"]
    iters = [c["iterations"] for c in chunks]
    n_solves = sum(c["solves"] for c in chunks)
    vals = model.logs[TOOLS_3D[0]][:, 1]
    log(
        f"3D main path on {card}: BM3 dip {DIP}, {len(DEPTHS_3D)} depths x {TOOLS_3D}, "
        f"{n_solves} solves in {len(chunks)} chunks of B={report['chunk']} "
        f"(S={report['n_solve_slots']}), CG iterations per chunk {iters}"
    )
    log(
        f"3D main path on {card}: {elapsed:.3f} s, {len(DEPTHS_3D) / elapsed:.3f} points/s, "
        f"{n_solves / elapsed:.3f} solves/s; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in report["phases"].items())
        + f"; launches {counts}; {graph_figures(report)}"
    )
    log(f"3D log Ra (ohm-m): min {vals.min():.4f}, max {vals.max():.4f}; meshed by "
        f"{report['mesher']}")
    if report["mesher"] != "native":
        raise AssertionError(f"3D main path meshed by {report['mesher']}, not natively")
    if not np.isfinite(vals).all():
        raise AssertionError(f"3D: {int((~np.isfinite(vals)).sum())} non-finite readouts")
    if report["n_failed_solves"] != 0:
        raise AssertionError(f"3D: {report['n_failed_solves']} failed solves")
    if not all(0 < k < 1000 for k in iters):
        raise AssertionError(f"3D CG iterations {iters} (maxiter 1000)")
    if launches < 5 * sum(iters) or counts["pcr_lines"] < 5 * sum(iters):
        raise AssertionError(f"K2 / K3 launched {launches} / {counts['pcr_lines']} times for CG "
                             f"iterations {iters}")
    if not all(c["replays"] == c["iterations"] - 1 for c in chunks):
        raise AssertionError(f"3D: CG graph replays {graph_figures(report)} for iterations {iters}")
    twin = eager_twin(torch, lambda: log_3d(torch, DEPTHS_3D, **cuda32),
                      lambda m: m.logs[TOOLS_3D[0]][:, 1])
    log(f"3D main path on {card} with the CG loop op by op: {twin['wall']:.3f} s")
    faults = graph_vs_eager("3D log (phase 8)", {"vals": vals, "iterations": iters,
                                                 "launches": counts}, twin)
    if faults:
        raise AssertionError("; ".join(faults))

    # ---- 9. kernels off, first 20 depths --------------------------------------------
    n_sub = 20
    t0 = time.perf_counter()
    plain = log_3d(torch, DEPTHS_3D[:n_sub], executor_overrides={"use_stencil_kernel": False},
                   **cuda32)
    plain_elapsed = time.perf_counter() - t0
    rel_plain = float(np.max(np.abs(plain.logs[TOOLS_3D[0]][:, 1] / vals[:n_sub] - 1)))
    log(
        f"3D first {n_sub} depths on {card} with the plain 27-point apply: "
        f"{plain_elapsed:.3f} s ({n_sub / plain_elapsed:.3f} points/s), CG iterations "
        f"{[c['iterations'] for c in plain.last_report['chunks']]}; readouts agree with "
        f"the kernel run to {rel_plain:.3e} (limit {LOG3D_REL_PAIR:g})"
    )
    if not rel_plain <= LOG3D_REL_PAIR:
        raise AssertionError(f"3D kernel vs plain: rel diff {rel_plain:.2e} > {LOG3D_REL_PAIR}")

    # ---- 10. card against CPU, float64 ----------------------------------------------
    spec = GridSpec3D(nz=49, np_=9, nr=17, n_wall_cells=3, n_blend_cells=2)
    sub = np.array([11.5, 12.5, 13.5])
    runs = {}
    for device in ("cuda", "cpu"):
        m = log_3d(torch, sub, device=device, dtype="float64", tol=1e-10, grid_spec3d=spec,
                   executor_overrides={"precond3d": "adi"})
        runs[device] = m.logs[TOOLS_3D[0]][:, 1]
    rel_cpu = float(np.max(np.abs(runs["cuda"] / runs["cpu"] - 1)))
    log(
        f"3D float64 cross-check at depths {sub.tolist()} on a 49x9x17 grid, tol 1e-10: "
        f"cuda vs cpu max rel diff {rel_cpu:.3e} (limit {LOG3D_REL_F64:g}); Ra {runs['cuda']}"
    )
    if not (np.isfinite(runs["cpu"]).all() and rel_cpu <= LOG3D_REL_F64):
        raise AssertionError(f"3D cuda vs cpu: rel diff {rel_cpu:.2e} > {LOG3D_REL_F64}")

    # ---- 11. uniform medium at dip 30 --------------------------------------------------
    from remo3d_tpu_torch import Model

    rho = 10.0
    uniform = Model.compute_synthetic_logs(
        TOOLS_3D, np.array([10.0, 12.5, 15.0]),
        np.array([[-100.0, 200.0, np.nan, np.nan, rho]]),
        np.array([[-100.0, 0.1, rho], [200.0, 0.1, rho]]),
        borehole_geometry_type="radius", dip=DIP, verbose=False, **cuda32,
    )
    worst_u = max(float(np.max(np.abs(v[:, 1] / rho - 1))) for v in uniform.logs.values())
    log(f"3D uniform medium {rho} ohm-m at dip {DIP}: worst |Ra/Rt - 1| = {worst_u:.3e} "
        f"(limit {UNIFORM3D_REL:g})")
    if not worst_u <= UNIFORM3D_REL:
        raise AssertionError(f"3D uniform medium: |Ra/Rt - 1| = {worst_u:.2e} > {UNIFORM3D_REL}")
    return launches, counts["pcr_lines"]


def mesh_seconds(report) -> float:
    """A log's host meshing: the executor's "mesh" phase and the pipeline's
    "mesh_ahead" (which overlaps the solves)."""
    return report["phases"].get("mesh", 0.0) + report["phases"].get("mesh_ahead", 0.0)


def measured_log(torch, make_log):
    """One log through ``Model.compute_synthetic_logs``: the kernels' counts
    set to 0 just before it and read just after, the wall around it, the peak
    of allocated device memory inside it. Returns (model, row)."""
    gc.collect()  # the peak is of this run alone
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    model = make_log()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    report = model.last_report
    return model, {
        "wall_s": wall,
        "solve_s": report["phases"]["solve"],
        "factor_s": report["factor_seconds"],
        "mesh_s": mesh_seconds(report),
        "chunk": int(report["chunk"]),
        "cg_iterations": [int(c["iterations"]) for c in report["chunks"]],
        "solves": int(sum(c["solves"] for c in report["chunks"])),
        "failed_solves": int(report["n_failed_solves"]),
        "launches": counts,
        "graph": graph_figures(report),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
    }


def screen(torch, card, dim, make_log, readouts, depths, kernel, iterative, unit):
    """Phases 12 and 13: one workload through the iterative preconditioner and
    the direct one under each schedule, in turns (iterative, bcr, scan, scan,
    bcr, iterative), then "fp" and the iterative one on the first depths. The
    second run of each preconditioner runs its CG loop op by op
    (:func:`eager`) and is held to the first, graphed one
    (:func:`graph_vs_eager`).

    ``make_log(depths, overrides, **kwargs)`` runs the log; ``readouts(model)``
    gives its values as an array. The reference is a float64 direct log at tol
    1e-10. Every float32 direct log is held to DIRECT_REL (relative) against
    it and against the first iterative log of the same depths, must have no
    failed solve and no NaN, must have launched ``kernel`` and, under an exact
    factor, must take at most DIRECT_MAX_ITERATIONS CG iterations per chunk; the
    iterative logs' distance from the reference is printed. Returns the rows."""
    key = "precond3d" if dim == "3D" else "preconditioner"
    limit64, limit = DIRECT_REL[dim]

    def direct(schedule, **more):
        return {key: "direct", "direct_schedule": schedule, **more}

    turns = [
        (iterative, {key: iterative}), ("direct-bcr", direct("bcr")),
        ("direct-scan", direct("scan")), ("direct-scan", direct("scan")),
        ("direct-bcr", direct("bcr")), (iterative, {key: iterative}),
    ]  # the second run of each: the CG loop op by op
    sub = depths[:N_FP_DEPTHS]
    turns_fp = [
        (iterative, {key: iterative}),
        ("direct-fp", direct("fp", direct_factor_passes=FP_PASSES[dim])),
    ]
    rows, faults = [], []
    for d, group in ((depths, turns), (sub, turns_fp)):
        t0 = time.perf_counter()
        truth = readouts(make_log(d, {key: "direct"}, dtype="float64", tol=1e-10))
        log(f"{dim} screen: float64 direct reference log of {len(d)} depths in "
            f"{time.perf_counter() - t0:.3f} s")
        if not np.isfinite(truth).all():
            raise AssertionError(f"{dim}: non-finite readouts in the float64 reference log")
        ref = None
        graphed = {}  # name -> the first run's readouts, iterations and launches
        for name, overrides in group:
            run = lambda: make_log(d, overrides)  # noqa: E731
            model, row = measured_log(torch, run if name not in graphed else lambda: eager(run))
            vals = readouts(model)
            row["cg_loop"] = "graph" if name not in graphed else "op by op"
            this = {"vals": vals, "iterations": row["cg_iterations"], "launches": row["launches"]}
            if name in graphed:
                faults += graph_vs_eager(f"{dim} {name}", graphed[name], this)
            else:
                graphed[name] = this
            n_nan = int((~np.isfinite(vals)).sum())
            if ref is None:
                ref = vals
            rel = float(np.max(np.abs(vals / ref - 1)))
            rel64 = float(np.max(np.abs(vals / truth - 1)))
            row = {"dim": dim, "preconditioner": name, "depths": len(d), **row,
                   "rate_per_s": len(d) * vals.shape[1] / row["wall_s"], "unit": unit,
                   "rel_to_iterative": rel, "rel_to_float64": rel64}
            if name == "direct-fp":
                row["passes"] = FP_PASSES[dim]
            rows.append(row)
            log(
                f"{dim} screen on {card}: {name:<12s} {len(d):3d} depths, CG loop "
                f"{row['cg_loop']}: wall {row['wall_s']:.3f} s "
                f"(solve {row['solve_s']:.3f} s, of which factor {row['factor_s']:.3f} s; mesh "
                f"{row['mesh_s']:.3f} s), {row['rate_per_s']:.3f} {unit}/s, {row['solves']} solves "
                f"in "
                f"chunks of B={row['chunk']}, CG iterations {row['cg_iterations']}, launches "
                f"{row['launches']}, {row['graph']}, peak memory "
                f"{row['peak_memory_bytes'] / 1e9:.3f} GB (reserved "
                f"{row['peak_reserved_bytes'] / 1e9:.3f} GB), readouts "
                f"vs {iterative} {rel:.3e} (limit {limit:g}), vs float64 {rel64:.3e} (limit for "
                f"direct {limit64:g})"
            )
            log("  per column vs float64: " + ", ".join(
                f"{float(np.max(np.abs(vals[:, i] / truth[:, i] - 1))):.1e}"
                for i in range(vals.shape[1])))
            if n_nan or row["failed_solves"]:
                faults.append(f"{name}: {n_nan} non-finite readouts, {row['failed_solves']} "
                              f"failed solves")
            most = DIRECT_MAX_ITERATIONS if name in ("direct-bcr", "direct-scan") else 999
            if not all(0 < k <= most for k in row["cg_iterations"]):
                faults.append(f"{name}: CG iterations {row['cg_iterations']} (at most {most})")
            if not rel <= limit:
                faults.append(f"{name} vs {iterative}: rel diff {rel:.2e} > {limit}")
            if name.startswith("direct") and not rel64 <= limit64:
                faults.append(f"{name} vs float64: rel diff {rel64:.2e} > {limit64}")
            if name.startswith("direct") and row["launches"][kernel] < sum(row["cg_iterations"]):
                faults.append(f"{name}: {kernel} launched {row['launches'][kernel]} times for CG "
                              f"iterations {row['cg_iterations']}")
    if faults:  # after every row was printed
        raise AssertionError(f"{dim} screen: " + "; ".join(faults))
    return rows


def screen_2d(torch, card):
    """Phase 12: the 2D log of phase 4 under each preconditioner."""

    def make_log(depths, overrides, dtype="float32", **kwargs):
        return log_2d(torch, depths, dtype, executor_overrides=overrides, **kwargs)

    def readouts(model):
        return np.stack([model.logs[t][:, 1] for t in EXAMPLE01_TOOLS], axis=1)

    return screen(torch, card, "2D", make_log, readouts, DEPTHS, "stencil2d_half", "multigrid",
                  "readouts")


def screen_3d(torch, card):
    """Phase 13: the 3D log of phase 8 under each preconditioner."""

    def make_log(depths, overrides, dtype="float32", **kwargs):
        return log_3d(torch, depths, device="cuda", dtype=dtype, executor_overrides=overrides,
                      **kwargs)

    def readouts(model):
        return model.logs[TOOLS_3D[0]][:, 1:2]

    return screen(torch, card, "3D", make_log, readouts, DEPTHS_3D, "stencil3d_half", "adi",
                  "points")


def direct_f64_cross_check(torch):
    """Phase 14: float64 direct logs on the card against the CPU, 3 depths,
    2D on a 97x33 grid at tol 1e-12 and 3D on 49x9x17 at tol 1e-10."""
    from remo3d_tpu_torch import Model
    from remo3d_tpu_torch.meshing.grid2d import GridSpec2D
    from remo3d_tpu_torch.meshing.grid3d import GridSpec3D

    spec2 = GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2)
    spec3 = GridSpec3D(nz=49, np_=9, nr=17, n_wall_cells=3, n_blend_cells=2)
    for schedule in ("scan", "bcr"):
        runs = {}
        for device in ("cuda", "cpu"):
            m2 = Model.compute_synthetic_logs(
                EXAMPLE01_TOOLS, DEPTHS[[20, 50, 80]], FORMATION, BOREHOLE,
                borehole_geometry_type="radius", dtype="float64", tol=1e-12, device=device,
                verbose=False, grid_spec=spec2,
                executor_overrides={"device_meshing": True, "preconditioner": "direct",
                                    "direct_schedule": schedule},
            )
            m3 = log_3d(torch, np.array([11.5, 12.5, 13.5]), device=device, dtype="float64",
                        tol=1e-10, grid_spec3d=spec3,
                        executor_overrides={"precond3d": "direct", "direct_schedule": schedule})
            runs[device] = (
                np.stack([m2.logs[t][:, 1] for t in EXAMPLE01_TOOLS], axis=1),
                m3.logs[TOOLS_3D[0]][:, 1],
                [c["iterations"] for c in m2.last_report["chunks"]],
                [c["iterations"] for c in m3.last_report["chunks"]],
            )
        rel2 = float(np.max(np.abs(runs["cuda"][0] / runs["cpu"][0] - 1)))
        rel3 = float(np.max(np.abs(runs["cuda"][1] / runs["cpu"][1] - 1)))
        log(
            f"float64 direct-{schedule} cross-check, cuda vs cpu: 2D 97x33 {rel2:.3e} (CG "
            f"iterations "
            f"{runs['cuda'][2]} / {runs['cpu'][2]}), 3D 49x9x17 {rel3:.3e} (CG iterations "
            f"{runs['cuda'][3]} / {runs['cpu'][3]}); limit {DIRECT_F64_REL:g}"
        )
        ok = all(np.isfinite(a).all() for run in runs.values() for a in run[:2])
        if not (ok and rel2 <= DIRECT_F64_REL and rel3 <= DIRECT_F64_REL):
            raise AssertionError(f"float64 direct-{schedule}: cuda vs cpu {rel2:.2e}, {rel3:.2e}")


def tf32_guard(torch):
    """Phase 15: the direct factor and apply under a caller who has switched
    TF32 products on. At the 2D path's width (761 lines of 161 nodes, 4
    batches x 5 solves) and on 33 planes of 17x49 in 3D, for "scan" and "bcr":
    the result must equal the one computed with TF32 off, the residual with it,
    and the caller's setting must still be there afterwards. For scale, the
    chain's apply without its guard is run under TF32 too."""
    from remo3d_tpu_torch.ops import block_bcr, block_bcr3d, block_direct, block_direct3d
    from remo3d_tpu_torch.ops.stencil import stencil_apply
    from remo3d_tpu_torch.ops.stencil3d import stencil3d_apply

    rng = np.random.default_rng(15)
    B, S = 4, 5
    C2 = torch.as_tensor(random_symmetric_stencil_2d(rng, B, 761, 161), device="cuda").float()
    b2 = torch.as_tensor(rng.standard_normal((B, S, 761, 161)), device="cuda").float()
    np_, nr = 17, 49
    C3 = random_symmetric_stencil_3d(rng, 2, 33, np_, nr)
    C3[..., 13] += 20.0  # 26 unit-variance couplings: make the diagonal dominate
    C3 = torch.as_tensor(C3, device="cuda").float()
    b3 = torch.as_tensor(rng.standard_normal((2, S, 33, np_, nr)), device="cuda").float()
    cases = {
        "2D scan": (lambda: block_direct.block_thomas_factor(C2),
                    lambda F: block_direct.block_thomas_apply(F, C2, b2),
                    lambda x: stencil_apply(C2, x) - b2, b2),
        "2D bcr": (lambda: block_bcr.bcr_factor(C2), lambda F: block_bcr.bcr_apply(F, b2),
                   lambda x: stencil_apply(C2, x) - b2, b2),
        "3D scan": (lambda: block_direct3d.block_thomas_factor_3d(C3, np_, nr),
                    lambda F: block_direct3d.block_thomas_apply_3d(F, C3, b3, np_, nr),
                    lambda x: stencil3d_apply(C3, x) - b3, b3),
        "3D bcr": (lambda: block_bcr3d.bcr_factor_3d(C3, np_, nr),
                   lambda F: block_bcr3d.bcr_apply_3d(F, b3, np_, nr),
                   lambda x: stencil3d_apply(C3, x) - b3, b3),
    }
    before = torch.get_float32_matmul_precision()
    if before != "highest":
        raise AssertionError(f"float32 matmul precision is {before!r} at the start")
    for name, (factor, apply, residual, b) in cases.items():
        results = {}
        for setting in ("highest", "high"):
            torch.set_float32_matmul_precision(setting)
            try:
                x = apply(factor())
                after = torch.get_float32_matmul_precision()
            finally:
                torch.set_float32_matmul_precision(before)
            if after != setting:
                raise AssertionError(f"{name}: the caller's {setting!r} became {after!r}")
            results[setting] = (x, float(residual(x).abs().max() / b.abs().max()))
        same = torch.equal(results["highest"][0], results["high"][0])
        r_off, r_on = results["highest"][1], results["high"][1]
        log(f"TF32 guard {name}: residual max|Ax-b|/max|b| {r_off:.3e} with TF32 off, {r_on:.3e} "
            f"with the caller's TF32 on; results {'equal' if same else 'differ'}")
        if not (same and r_on == r_off and r_on <= 1e-4):
            raise AssertionError(f"TF32 guard {name}: {r_off:.3e} vs {r_on:.3e}, equal: {same}")
        del results
    # What the guard keeps out: the chain's apply without it, TF32 on.
    F = block_direct.block_thomas_factor(C2)
    torch.set_float32_matmul_precision("high")
    try:
        allow = torch.backends.cuda.matmul.allow_tf32
        x = block_direct.block_thomas_apply.__wrapped__(F, C2, b2)
    finally:
        torch.set_float32_matmul_precision(before)
    r_bare = float((stencil_apply(C2, x) - b2).abs().max() / b2.abs().max())
    log(f"TF32 guard: 2D scan apply without the guard under TF32 (allow_tf32 = {allow}): "
        f"residual {r_bare:.3e}")
    if not allow:
        raise AssertionError("set_float32_matmul_precision('high') did not switch TF32 on")
    torch.cuda.empty_cache()


def run_screen(torch, card):
    """Phases 12-15; returns the screen's rows."""
    rows = screen_2d(torch, card)
    torch.cuda.empty_cache()
    rows += screen_3d(torch, card)
    torch.cuda.empty_cache()
    direct_f64_cross_check(torch)
    tf32_guard(torch)
    return rows


def check_autograd(torch):
    """Phase 16: K1 and K2 under autograd. Returns {kernel: {"contraction_ms",
    "contraction_bound_ms"}} at the main shapes."""
    from remo3d_tpu_torch.kernels import stencil2d, stencil3d

    rng = np.random.default_rng(16)
    cases = [
        ("K1", KERNEL_SHAPES[0], None), ("K1", KERNEL_SHAPES[3], None),
        ("K2", KERNEL3D_SHAPES[0], False), ("K2", KERNEL3D_SHAPES[0], True),
        ("K2", KERNEL3D_SHAPES[3], False), ("K2", KERNEL3D_SHAPES[3], True),
    ]
    out = {}
    for label, shape, pole in cases:
        B, S = shape[:2]
        if label == "K1":
            C = stencil2d.half_planes_2d(torch.as_tensor(
                random_symmetric_stencil_2d(rng, B, *shape[2:]), device="cuda").float())
            kernel = stencil2d.stencil_apply_half_2d
            plain = stencil2d.stencil_apply_half_2d_plain
            contraction = stencil2d.stencil_half_coeff_grad_2d
        else:
            C = stencil3d.half_planes_3d(torch.as_tensor(
                random_symmetric_stencil_3d(rng, B, *shape[2:]), device="cuda").float())
            kernel = lambda C, u, pole=pole: stencil3d.stencil3d_apply_half(C, u, pole)  # noqa: E731
            plain = lambda C, u, pole=pole: stencil3d.stencil3d_apply_half_plain(C, u, pole)  # noqa: E731
            contraction = lambda g, u, pole=pole: stencil3d.stencil_half_coeff_grad_3d(g, u, pole)  # noqa: E731
        C.requires_grad_(True)
        u = torch.randn(shape, device="cuda", requires_grad=True)
        g = torch.randn(shape, device="cuda")
        reset_counts()
        y = kernel(C, u)
        if not (y.requires_grad and y.grad_fn is not None):
            raise AssertionError(f"{label} {shape}: the kernel output has no grad_fn")
        grads = torch.autograd.grad((y * g).sum(), (C, u))
        launches = sum(read_counts().values())
        refs = torch.autograd.grad((plain(C, u) * g).sum(), (C, u))
        errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(grads, refs)]
        log(f"autograd {label} {shape} pole={pole}: grad_C_half {errs[0]:.3e}, grad_u "
            f"{errs[1]:.3e} relative to max|grad| against autograd of the plain version "
            f"(tolerance {TOL_REL['float32']:g}); {launches} launches for the apply and "
            f"its backward")
        if not (max(errs) <= TOL_REL["float32"] and launches == 2):
            raise AssertionError(f"autograd {label} {shape}: {errs}, {launches} launches")
        if shape in (KERNEL_SHAPES[0], KERNEL3D_SHAPES[0]) and pole is not True:
            gd, ud = g.detach(), u.detach()
            for _ in range(3):
                contraction(gd, ud)
            ms = float(np.median([time_ms(torch, lambda: contraction(gd, ud)) for _ in range(25)]))
            n_half = C.shape[1]
            n_nodes = math.prod(shape[2:])
            n_bytes = 4.0 * B * n_nodes * (2 * S + n_half)
            b_ms, b_by = bound_ms(n_bytes, 4.0 * B * S * n_nodes * n_half, "float32")
            out[label] = {"contraction_ms": ms, "contraction_bound_ms": b_ms}
            log(f"autograd {label} {shape}: coefficient contraction {ms:.4f} ms (median of 25), "
                f"bound {b_ms:.4f} ms by {b_by} ({n_bytes / 1e6:.1f} MB)")
        del C, u, g, y, grads, refs
    for shape, fn in (
        ((1, 2, 7, 5), lambda C, u: stencil2d.stencil_apply_half_2d(C, u)),
        ((1, 2, 6, 3, 5), lambda C, u: stencil3d.stencil3d_apply_half(C, u, False)),
        ((1, 2, 6, 3, 5), lambda C, u: stencil3d.stencil3d_apply_half(C, u, True)),
    ):
        if len(shape) == 4:
            C = stencil2d.half_planes_2d(torch.as_tensor(
                random_symmetric_stencil_2d(rng, 1, *shape[2:]), device="cuda"))
        else:
            C = stencil3d.half_planes_3d(torch.as_tensor(
                random_symmetric_stencil_3d(rng, 1, *shape[2:]), device="cuda"))
        C.requires_grad_(True)
        u = torch.randn(shape, device="cuda", dtype=torch.float64, requires_grad=True)
        ok = torch.autograd.gradcheck(fn, (C, u), check_forward_ad=True)
        log(f"autograd gradcheck float64 {shape}: {'passed' if ok else 'FAILED'} (reverse and "
            f"forward mode)")
        if not ok:
            raise AssertionError(f"gradcheck {shape} failed")
    torch.cuda.empty_cache()
    return out


def diff_measure(torch, fn):
    """Run ``fn`` with the kernels' counts set to 0 just before and read just
    after: (result, wall seconds, launches, peak allocated bytes)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return result, wall, read_counts(), torch.cuda.max_memory_allocated()


def diff_seconds(dlog) -> str:
    """The last call's seconds of assembly, factorization and solves, summed
    over its chunks (CUDA events)."""
    chunks = dlog.last_report["chunks"]
    return ", ".join(f"{key[:-2]} {sum(c[key] for c in chunks):.3f} s"
                     for key in ("assembly_s", "factor_s", "solve_s"))


def diff_run(torch, card, dim, dlog, ref, kernel, fd_params):
    """Phases 17 and 18 on one DifferentiableLog: forward against the Model log
    ``ref``, reverse against forward mode, finite differences on
    ``fd_params`` (None = the two most sensitive). The first forward and
    Jacobian calls (warm-ups) and one more taped forward and backward run
    their CG loops op by op, held to the graphed calls (:func:`graph_vs_eager`).
    Returns the launches of ``kernel`` in the forward, the backward and the
    Jacobian."""
    p0 = np.asarray(dlog.params0, dtype=np.float64)

    def iterations(key):
        return [c[key] for c in dlog.last_report["chunks"]]

    out0, wall_f0, n_f0, _ = diff_measure(torch, lambda: eager(lambda: dlog.forward(p0)))
    op_by_op = {"vals": out0.cpu().numpy(), "iterations": iterations("iterations"),
                "launches": n_f0}
    out, wall_f, n_f, mem_f = diff_measure(torch, lambda: dlog.forward(p0))
    it_f = iterations("iterations")
    vals = out.cpu().numpy()
    faults = graph_vs_eager(f"diff {dim} forward", {"vals": vals, "iterations": it_f,
                                                     "launches": n_f}, op_by_op)
    rel = float(np.nanmax(np.abs(vals / ref - 1)))
    log(f"diff {dim} on {card}: forward {wall_f:.3f} s (first call, CG op by op, "
        f"{wall_f0:.3f} s), CG "
        f"iterations {it_f}, launches {n_f}, peak memory {mem_f / 1e9:.3f} GB, "
        f"{diff_seconds(dlog)}; against the direct Model log {rel:.3e} (limit "
        f"{DIFF_FORWARD_REL[dim]:g})")
    if not (np.isfinite(vals).all() and rel <= DIFF_FORWARD_REL[dim]):
        raise AssertionError(f"diff {dim}: forward vs Model {rel:.3e}")

    rng = np.random.default_rng(3)
    w = torch.as_tensor(rng.standard_normal(vals.shape), device="cuda", dtype=torch.float32)
    p = torch.tensor(p0, device="cuda", dtype=torch.float32, requires_grad=True)

    def taped():
        logs = dlog(p)
        return torch.where(torch.isnan(logs), 0.0, logs * w).sum()

    loss, wall_r, n_r, mem_r = diff_measure(torch, taped)
    seconds_r = diff_seconds(dlog)
    (g_rev,), wall_b, n_b, mem_b = diff_measure(torch, lambda: torch.autograd.grad(loss, p))
    it_b = [c.get("adjoint_iterations") for c in dlog.last_report["chunks"]]
    del loss

    def taped_backward():
        return torch.autograd.grad(taped(), p)[0]

    g_eager, _, n_e, _ = diff_measure(torch, lambda: eager(taped_backward))
    n_rb = {k: n_r[k] + n_b[k] for k in n_r}
    faults += graph_vs_eager(
        f"diff {dim} taped forward + backward",
        {"vals": g_rev.cpu().numpy(), "iterations": it_b, "launches": n_rb},
        {"vals": g_eager.cpu().numpy(), "launches": n_e,
         "iterations": [c.get("adjoint_iterations") for c in dlog.last_report["chunks"]]})

    J0, wall_j0, n_j0, _ = diff_measure(torch, lambda: eager(lambda: dlog.jacobian(p0)))
    op_by_op = {"vals": J0.cpu().numpy(), "iterations": iterations("tangent_iterations"),
                "launches": n_j0}
    J, wall_j, n_j, mem_j = diff_measure(torch, lambda: dlog.jacobian(p0))
    it_j = iterations("tangent_iterations")
    faults += graph_vs_eager(f"diff {dim} Jacobian", {"vals": J.cpu().numpy(), "iterations": it_j,
                                                      "launches": n_j}, op_by_op)
    if faults:
        raise AssertionError("; ".join(faults))
    seconds_j = diff_seconds(dlog)
    J = J.cpu().numpy()
    g_fwd = np.einsum("mtp,mt->p", J, w.cpu().numpy())
    scale = float(np.abs(g_fwd).max())
    err = float(np.abs(g_rev.cpu().numpy() - g_fwd).max())
    log(f"diff {dim} on {card}: taped forward {wall_r:.3f} s (launches {n_r}, peak memory "
        f"{mem_r / 1e9:.3f} GB, {seconds_r}), backward {wall_b:.3f} s (adjoint "
        f"CG iterations {it_b}, launches {n_b}, peak memory {mem_b / 1e9:.3f} GB); Jacobian "
        f"{tuple(J.shape)} {wall_j:.3f} s (first call, CG op by op, {wall_j0:.3f} s; tangent "
        f"CG iterations "
        f"{it_j}, launches {n_j}, peak memory {mem_j / 1e9:.3f} GB, {seconds_j}); reverse vs "
        f"forward mode {err / scale:.3e} of scale "
        f"(limit {DIFF_REV_FWD:g})")
    if not (scale > 0 and err <= DIFF_REV_FWD * scale):
        raise AssertionError(f"diff {dim}: reverse vs forward mode {err:.3e}, scale {scale:.3e}")

    if fd_params is None:
        fd_params = [int(k) for k in np.argsort(np.abs(J).sum(axis=(0, 1)))[-2:]]
    for k in fd_params:
        h = 0.02 * p0[k]
        pp, pm = p0.copy(), p0.copy()
        pp[k] += h
        pm[k] -= h
        fd = (np.nan_to_num(dlog.forward(pp).cpu().numpy())
              - np.nan_to_num(dlog.forward(pm).cpu().numpy())) / (2 * h)
        fd_scale = float(np.abs(fd).max())
        fd_err = float(np.max(np.abs(J[:, :, k] - fd) - DIFF_FD[dim] * np.abs(fd)))
        log(f"diff {dim}: finite differences on {dlog.param_names[k]}: max|J - fd| "
            f"{float(np.abs(J[:, :, k] - fd).max()):.3e}, scale {fd_scale:.3e} (limit "
            f"{DIFF_FD[dim]:g} of scale + {DIFF_FD[dim]:g} of |fd|)")
        if not (fd_scale > 0 and fd_err <= DIFF_FD[dim] * fd_scale):
            raise AssertionError(f"diff {dim}: finite differences on parameter {k}")
    launches = {"forward": n_f[kernel], "backward": n_b[kernel], "jacobian": n_j[kernel]}
    if min(launches.values()) <= 0:
        raise AssertionError(f"diff {dim}: {kernel} launches {launches}")
    torch.cuda.empty_cache()
    return {f"launches_diff_{key}": n for key, n in launches.items()}


def diff_2d(torch, card):
    """Phase 17: the 2D differentiable forward at full width."""
    from remo3d_tpu_torch import DifferentiableLog, Model

    model = Model(DIFF_TOOLS)
    model.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius")
    model.simulate_logs(DIFF_DEPTHS, preconditioner="direct", device="cuda", verbose=False,
                        executor_overrides={"chunk_size": 8, "device_meshing": False})
    ref = np.stack([model.logs[t][:, 1] for t in DIFF_TOOLS], axis=1)
    dlog = DifferentiableLog(model, DIFF_DEPTHS, chunk_size=8, device="cuda")
    log(f"diff 2D: {len(dlog.params0)} parameters {dlog.param_names}, "
        f"{dlog._stacked['coords'].shape[:2]} (chunks, batches per chunk), schedule "
        f"{dlog.direct_schedule}")
    return diff_run(torch, card, "2D", dlog, ref, "stencil2d_half", None)


def diff_3d(torch, card):
    """Phase 18: the 3D differentiable forward at full width."""
    from remo3d_tpu_torch import DifferentiableLog, Model
    from remo3d_tpu_torch.meshing.grid3d import GridSpec3D

    model = Model([DIFF_TOOL_3D])
    model.set_model_parameters(DIFF_FORMATION_3D, DIFF_BOREHOLE_3D,
                               borehole_geometry_type="radius", dip=DIP)
    model.simulate_logs(DIFF_DEPTHS_3D, domain_radius=10.0, device="cuda", verbose=False,
                        grid_spec3d=GridSpec3D(), executor_overrides={"precond3d": "direct"})
    ref = model.logs[DIFF_TOOL_3D][:, 1:2]
    dlog = DifferentiableLog(model, DIFF_DEPTHS_3D, grid_spec3d=GridSpec3D(), domain_radius=10.0,
                             chunk_size=8, device="cuda")
    log(f"diff 3D: {len(dlog.params0)} parameters {dlog.param_names}, "
        f"{dlog._stacked['coords'].shape[:2]} (chunks, batches per chunk), schedule "
        f"{dlog.direct_schedule}")
    return diff_run(torch, card, "3D", dlog, ref, "stencil3d_half", (0, 3))


def diff_cpu_and_inversion(torch, card):
    """Phase 19: forward and Jacobian of the 2D log on a 193x41 grid, card
    against CPU; then Example_05's inversion
    (``remo3d_tpu_torch.examples.example_05_dip_inversion``) on the card."""
    from remo3d_tpu_torch import DifferentiableLog, Model
    from remo3d_tpu_torch.meshing.grid2d import GridSpec2D

    model = Model(DIFF_TOOLS)
    model.set_model_parameters(FORMATION, BOREHOLE, borehole_geometry_type="radius")
    spec = GridSpec2D(nz=193, nr=41, n_wall_cells=6, n_blend_cells=3)
    runs = {}
    for device in ("cuda", "cpu"):
        dlog = DifferentiableLog(model, DIFF_DEPTHS, grid_spec=spec, chunk_size=8, device=device)
        t0 = time.perf_counter()
        runs[device] = [dlog.forward(dlog.params0).cpu().numpy(),
                        dlog.jacobian(dlog.params0).cpu().numpy(), time.perf_counter() - t0]
    rel = float(np.nanmax(np.abs(runs["cuda"][0] / runs["cpu"][0] - 1)))
    jac = float(np.abs(runs["cuda"][1] - runs["cpu"][1]).max() / np.abs(runs["cpu"][1]).max())
    log(f"diff card vs CPU, 2D 193x41: forward {rel:.3e} (limit {DIFF_CPU_REL:g}), Jacobian "
        f"{jac:.3e} of scale (limit {DIFF_CPU_JAC:g}); forward + Jacobian {runs['cuda'][2]:.3f} s "
        f"on the card, {runs['cpu'][2]:.3f} s on the CPU")
    if not (rel <= DIFF_CPU_REL and jac <= DIFF_CPU_JAC):
        raise AssertionError(f"diff card vs CPU: {rel:.3e}, {jac:.3e}")

    # The Levenberg-Marquardt inversion of Example_05 on its 49x7x21 grid.
    from remo3d_tpu_torch.examples import example_05_dip_inversion

    r = example_05_dip_inversion.main(device="cuda")
    log(f"diff inversion on {card}: {r['iterations']} iterations in {r['seconds']:.3f} s, "
        f"rms log-misfit {r['misfit']:.2e}, worst parameter error {r['worst']:.3%} (limit 0.1%)")
    if not (r["misfit"] < 1e-4 and r["worst"] < 1e-3):
        raise AssertionError(f"diff inversion: misfit {r['misfit']:.2e}, worst error "
                             f"{r['worst']:.3%}")


def run_diff(torch, card):
    """Phases 16-19; returns ({kernel: phase 16's timings}, {kernel: launches})."""
    timings = check_autograd(torch)
    launches = {"stencil2d_half": diff_2d(torch, card)}
    launches["stencil3d_half"] = diff_3d(torch, card)
    diff_cpu_and_inversion(torch, card)
    return timings, launches


def probe(torch, card):
    """K2 at its main shape, float32, beside its three probe builds: 20
    interleaved rounds, median per build. The probe builds compute wrong
    results on purpose; only their times mean something."""
    from remo3d_tpu_torch.kernels import build, stencil3d

    builds = {
        "the kernel": (),
        "probe 1, mirrored coefficients not loaded": ("REMO3D_K2_PROBE=1",),
        "probe 2, no coefficient loaded": ("REMO3D_K2_PROBE=2",),
        "probe 3, no sum over shared memory": ("REMO3D_K2_PROBE=3",),
    }
    libs = {key: build.build_library(defines) for key, defines in builds.items()}
    shape = KERNEL3D_SHAPES[0]
    B, S, nz, np_, nr = shape
    rng = np.random.default_rng(2024)
    C_half = stencil3d.half_planes_3d(torch.as_tensor(
        random_symmetric_stencil_3d(rng, B, nz, np_, nr), device="cuda").float())
    u = torch.as_tensor(rng.standard_normal(shape), device="cuda").float()
    y = torch.empty_like(u)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        err = lib.stencil3d_half_f32(C_half.data_ptr(), u.data_ptr(), y.data_ptr(), B, S, nz,
                                     np_, nr, 0, 0, stream)
        if err != 0:
            raise RuntimeError(f"probe launch failed: CUDA error {err}")

    times = {key: [] for key in libs}
    for rnd in range(21):  # round 0 warms up
        for key, lib in libs.items():
            t = time_ms(torch, lambda: call(lib))
            if rnd:
                times[key].append(t)
    for key in libs:
        log(f"probe K2 {shape} float32 on {card}: {key}: {float(np.median(times[key])):.4f} ms")
    probe_k3(torch, card)


def tune_k3(torch, card):
    """K3 at every line shape of phases 4 and 8 (:func:`k3_shapes`), float32
    and float64, for the 12 candidate plans of least estimated cost
    (``pcr_lines.candidate_plans``, ``estimated_cost``; the first is
    ``tile_plan``'s), the 4 least of those of 1024 blocks or more, the least
    of each cluster size and occupancy, and the strided plans among the first
    12 in a cluster of one block: each checked against the plain version,
    then 5 interleaved rounds, median per plan, beside its estimate. How
    tile_plan's cost model was fitted."""
    from remo3d_tpu_torch.kernels import build, pcr_lines
    from remo3d_tpu_torch.ops.lines import pcr_factor_stacked

    lib = build.load_library()
    rng = np.random.default_rng(2024)
    for label, B, S, grid, axis in k3_shapes():
        shape = (B, *grid)
        dl, du = -rng.uniform(0.1, 1.0, shape), -rng.uniform(0.1, 1.0, shape)
        d = -(dl + du) + rng.uniform(0.05, 0.5, shape)
        b64 = rng.standard_normal(shape if S is None else (B, S, *grid))
        for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            F = pcr_factor_stacked(*(torch.as_tensor(a, device="cuda").to(dt)
                                     for a in (dl, d, du)), axis=axis, stack_dim=1)
            b = torch.as_tensor(b64, device="cuda").to(dt)
            x = torch.empty_like(b)
            ref = pcr_lines.pcr_apply_lines_plain(F, b, axis)
            outer, n, inner = pcr_lines.line_view(grid, axis)
            L, size = (F.shape[1] - 1) // 2, b.element_size()

            def blocks(p):
                return B * p.tiles_o * p.tiles_i * p.cluster

            ranked = sorted(pcr_lines.candidate_plans(S or 1, outer, n, inner, L, size),
                            key=lambda p: (pcr_lines.estimated_cost(B, S or 1, size, p), p.smem))
            plans = ranked[:12]
            plans += [p for p in ranked if blocks(p) >= 1024 and p not in plans][:4]
            kinds = {}
            for p in ranked:
                kinds.setdefault((p.cluster, pcr_lines.occupancy(p.smem)), p)
            plans += [p for p in kinds.values() if p not in plans]
            one = [pcr_lines.make_plan(S or 1, outer, n, inner, L, size, p.tiles_o, p.tiles_i,
                                       1, p.stages) for p in ranked[:12] if p.cluster > 1]
            plans += [p for p in dict.fromkeys(one)
                      if p.smem <= pcr_lines.MAX_SMEM_BYTES and p not in plans]
            times = {p: [] for p in plans}
            for p in plans:
                pcr_lines.launch(lib, F, b, x, axis, p)
                torch.cuda.synchronize()
                rel = float((x - ref).abs().max()) / float(ref.abs().max())
                if not rel <= TOL_REL[name]:
                    raise AssertionError(f"K3 {label} {name} plan {p}: rel err {rel:.3e}")
            for rnd in range(6):  # round 0 warms up
                for p in plans:
                    t = time_ms(torch, lambda: pcr_lines.launch(lib, F, b, x, axis, p))
                    if rnd:
                        times[p].append(t)
            for i, p in enumerate(plans):
                log(f"tune K3 {label} {tuple(b.shape)} {name} on {card}: {tuple(p)} "
                    f"{'(tile_plan) ' if i == 0 else ''}{blocks(p)} blocks, "
                    f"{pcr_lines.occupancy(p.smem)} per SM, estimate "
                    f"{pcr_lines.estimated_cost(B, S or 1, size, p):.0f}: "
                    f"{float(np.median(times[p])):.4f} ms")
            del F, b, x, ref
        torch.cuda.empty_cache()


def probe_k3(torch, card):
    """K3 at the five main-path line shapes (2D finest z and r, 3D z, p and
    r), float32, beside its two probe builds (``REMO3D_K3_PROBE`` in
    ``csrc/pcr_lines.cu``): without any coefficient loaded (constants in
    their place), and without the barrier between levels. 20 interleaved
    rounds, median per build; wrong results on purpose, only the times mean
    something."""
    from remo3d_tpu_torch.kernels import build, pcr_lines
    from remo3d_tpu_torch.ops.lines import pcr_factor_stacked

    builds = {
        "the kernel": (),
        "probe 1, no coefficient loaded": ("REMO3D_K3_PROBE=1",),
        "probe 2, no barrier between levels": ("REMO3D_K3_PROBE=2",),
    }
    libs = {key: build.build_library(defines) for key, defines in builds.items()}
    rng = np.random.default_rng(2024)
    shapes = [s for s in k3_shapes() if s[2] is not None and s[0] in MAIN_K3_SHAPES]
    for label, B, S, grid, axis in shapes:
        shape = (B, *grid)
        dl, du = -rng.uniform(0.1, 1.0, shape), -rng.uniform(0.1, 1.0, shape)
        d = -(dl + du) + rng.uniform(0.05, 0.5, shape)
        F = pcr_factor_stacked(*(torch.as_tensor(a, device="cuda").float() for a in (dl, d, du)),
                               axis=axis, stack_dim=1)
        b = torch.as_tensor(rng.standard_normal((B, S, *grid)), device="cuda").float()
        x = torch.empty_like(b)
        times = {key: [] for key in libs}
        for rnd in range(21):  # round 0 warms up
            for key, lib in libs.items():
                t = time_ms(torch, lambda: pcr_lines.launch(lib, F, b, x, axis))
                if rnd:
                    times[key].append(t)
        for key in libs:
            log(f"probe K3 {label} {tuple(b.shape)} float32 on {card}: {key}: "
                f"{float(np.median(times[key])):.4f} ms")
        del F, b, x


def device_activity(torch, events):
    """Of a profile's events: the device activities (kernels and copies), the
    sum of their times and the union of their intervals, both in ms."""
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time_total for e in kernels) / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return kernels, total, busy / 1e3


def profile_direct(torch, card):
    """One warm direct log per dimension and exact schedule under
    torch.profiler: the wall, the device busy share (union of kernel
    intervals over the profiled wall), the factorization's seconds and the
    ten device activities that take most time."""
    from torch.profiler import ProfilerActivity, profile

    from remo3d_tpu_torch import Model

    def log_2d(overrides):
        return Model.compute_synthetic_logs(
            EXAMPLE01_TOOLS, DEPTHS, FORMATION, BOREHOLE, borehole_geometry_type="radius",
            dtype="float32", device="cuda", verbose=False, executor_overrides=overrides)

    def log_3(overrides):
        return log_3d(torch, DEPTHS_3D, device="cuda", dtype="float32",
                      executor_overrides=overrides)

    cases = [
        (f"{dim} direct-{schedule}", make, {key: "direct", "direct_schedule": schedule})
        for dim, make, key in (("2D", log_2d, "preconditioner"), ("3D", log_3, "precond3d"))
        for schedule in ("bcr", "scan")
    ]
    for label, make, overrides in cases:
        make(overrides)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model = make(overrides)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels, total, busy = device_activity(torch, prof.events())
        report = model.last_report
        log(f"profile {label} on {card}: wall {wall_ms:.1f} ms (solve phase "
            f"{report['phases']['solve'] * 1e3:.1f} ms, of which factor "
            f"{report['factor_seconds'] * 1e3:.1f} ms), CG iterations "
            f"{[c['iterations'] for c in report['chunks']]}, {len(kernels)} device activities, "
            f"kernel time {total:.1f} ms, busy {busy:.1f} ms = {busy / wall_ms:.3f} of the wall")
        log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=10,
                                      max_name_column_width=60))
        del prof, model


def tune_direct(torch, card):
    """What the direct solvers' inversions cost and how ``z_block`` was chosen:
    ``torch.linalg.inv`` beside a Cholesky route at the block shapes of the two
    main paths, then ``bcr_factor_3d`` at (8, 193, 17, 49) and
    ``schur_fixedpoint_factor_3d`` at two batches for several ``z_block``."""
    from remo3d_tpu_torch.ops.block_bcr3d import bcr_apply_3d, bcr_factor_3d
    from remo3d_tpu_torch.ops.block_direct3d import schur_fixedpoint_factor_3d

    def wall_ms(fn, n=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    shapes = [(74, 161, 161), (28120, 161, 161), (8, 833, 833), (64, 833, 833), (8, 1625, 1625)]
    for shape in shapes:
        A = torch.randn(shape, device="cuda")
        A = A @ A.transpose(-1, -2) + shape[-1] * torch.eye(shape[-1], device="cuda")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        inv = wall_ms(lambda: torch.linalg.inv(A))
        extra = (torch.cuda.max_memory_allocated() - base) / 1e9
        chol = wall_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky(A)))
        log(f"tune-direct on {card}: {shape} float32 SPD: torch.linalg.inv {inv:.2f} ms "
            f"(+{extra:.2f} GB at its peak), cholesky + cholesky_inverse {chol:.2f} ms")
        del A
    rng = np.random.default_rng(0)
    np_, nr = KERNEL3D_SHAPES[0][3:]
    C = random_symmetric_stencil_3d(rng, 8, 193, np_, nr)
    C[..., 13] += 20.0  # 26 unit-variance couplings: make the diagonal dominate
    C = torch.as_tensor(C, device="cuda").float()
    b = torch.randn(KERNEL3D_SHAPES[0], device="cuda")
    for z_block in (4, 8, 16, 32, 96):
        F = None
        torch.cuda.reset_peak_memory_stats()

        def factor():
            nonlocal F
            F = None
            F = bcr_factor_3d(C, np_, nr, z_block=z_block)

        f_ms = wall_ms(factor, n=2)
        peak = torch.cuda.max_memory_allocated() / 1e9
        a_ms = wall_ms(lambda: bcr_apply_3d(F, b, np_, nr))
        log(f"tune-direct on {card}: bcr_factor_3d (8,193,{np_},{nr}) z_block {z_block}: "
            f"{f_ms:.1f} ms, peak {peak:.2f} GB; bcr_apply_3d on 5 solves {a_ms:.2f} ms")
        del F
    for z_block in (8, 16, 64):
        torch.cuda.reset_peak_memory_stats()
        f_ms = wall_ms(lambda: schur_fixedpoint_factor_3d(C[:2], np_, nr, passes=8,
                                                          z_block=z_block), n=1)
        log(f"tune-direct on {card}: schur_fixedpoint_factor_3d (2,193,{np_},{nr}) 8 passes "
            f"z_block {z_block}: {f_ms:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def log_2d(torch, depths, dtype="float32", **kwargs):
    """Phase 4's log (6 tools, this script's formation) on the card."""
    from remo3d_tpu_torch import Model

    return Model.compute_synthetic_logs(
        EXAMPLE01_TOOLS, depths, FORMATION, BOREHOLE, borehole_geometry_type="radius",
        domain_radius=50, batch_size=5, dtype=dtype, device="cuda", verbose=False, **kwargs,
    )


def readouts_2d(model):
    return np.stack([model.logs[t][:, 1] for t in EXAMPLE01_TOOLS], axis=1)


def native_mesher(torch, card):
    """Phase 20: the native mesher's grids against the numpy builders', then the
    100-point 3D log meshed both ways."""
    from remo3d_tpu_torch.meshing import native
    from remo3d_tpu_torch.meshing.carve import carve_local_model
    from remo3d_tpu_torch.meshing.grid2d import GridSpec2D, build_grid2d
    from remo3d_tpu_torch.meshing.grid3d import GridSpec3D, build_grid3d
    from remo3d_tpu_torch.planner import plan_tasks
    from remo3d_tpu_torch.tools import parse_tools

    if not native.native_available():
        raise AssertionError(f"native mesher: {native.load_error()}")
    cases = [
        ("2D 761x161", EXAMPLE01_TOOLS, FORMATION, BOREHOLE, DEPTHS[[0, 50, 100]], 0,
         GridSpec2D()),
        (f"3D 193x17x49 dip {DIP}", TOOLS_3D, BM3_FORMATION, BM3_BOREHOLE,
         DEPTHS_3D[[0, 40, 80]], DIP, GridSpec3D()),
        ("3D high_dip 257x25x65 dip 60", TOOLS_3D, BM3_FORMATION, BM3_BOREHOLE,
         DEPTHS_3D[[0, 40, 80]], 60, GridSpec3D.high_dip()),
    ]
    for label, names, formation, borehole, depths, dip_deg, spec in cases:
        tools, sec = parse_tools(names, True)
        _, tasks = plan_tasks(tools, sec, depths, 1)
        dip = np.deg2rad(dip_deg)
        builders = ((native.build_grid3d_native, build_grid3d) if dip_deg else
                    (native.build_grid2d_native, build_grid2d))
        coord_err = sigma_err = 0.0
        seconds = [0.0, 0.0]
        for t in tasks:
            lm = carve_local_model(formation, borehole[:, :2], 1.0, t.center_depth, 50.0,
                                   dip_rad=dip, active_geometry_window=0.99 if dip_deg else 0.999)
            sources = np.unique(np.concatenate([s.source_positions for s in t.solves]))
            args = (spec, 50.0, lm, *((dip,) if dip_deg else ()), t.electrode_positions, sources)
            grids = []
            for k, build_fn in enumerate(builders):
                t0 = time.perf_counter()
                grids.append(build_fn(*args))
                seconds[k] += time.perf_counter() - t0
            g_c, g_py = grids
            coord_err = max(coord_err, float(np.abs(g_c.coords - g_py.coords).max()),
                            float(np.abs(g_c.z_axis - g_py.z_axis).max()))
            sigma_err = max(sigma_err, float(np.abs(g_c.sigma_cells / g_py.sigma_cells - 1).max()))
            sigma_ok = (np.array_equal(g_c.sigma_cells, g_py.sigma_cells) if not dip_deg else
                        np.allclose(g_c.sigma_cells, g_py.sigma_cells, rtol=NATIVE_SIGMA3D_RTOL,
                                    atol=0))
            if not (coord_err <= NATIVE_COORD_ATOL and sigma_ok
                    and np.array_equal(g_c.free_mask, g_py.free_mask)):
                raise AssertionError(f"native mesher {label} at {t.center_depth}: coords "
                                     f"{coord_err:.2e}, sigma {sigma_err:.2e}")
        log(f"native mesher {label}, {len(tasks)} batches: native vs numpy coords {coord_err:.2e} "
            f"(limit {NATIVE_COORD_ATOL:g}), sigma {sigma_err:.2e} relative (limit "
            f"{'0' if not dip_deg else f'{NATIVE_SIGMA3D_RTOL:g}'}), masks equal; build "
            f"{seconds[0] / len(tasks) * 1e3:.1f} ms native, {seconds[1] / len(tasks) * 1e3:.1f} "
            f"ms numpy per batch")

    runs = {}
    for name, on in (("numpy", False), ("native", True)):
        model, wall, _, _ = diff_measure(torch, lambda: log_3d(
            torch, DEPTHS_3D, device="cuda", dtype="float32",
            executor_overrides={"use_native_mesher": on}))
        report = model.last_report
        runs[name] = model.logs[TOOLS_3D[0]][:, 1]
        log(f"3D main path on {card} meshed by {report['mesher']}: wall {wall:.3f} s, mesh "
            f"{mesh_seconds(report):.3f} s, solve {report['phases']['solve']:.3f} s, "
            f"{report['n_failed_solves']} failed solves")
        if report["mesher"] != name or report["n_failed_solves"]:
            raise AssertionError(f"3D log with use_native_mesher={on}: meshed by "
                                 f"{report['mesher']}, {report['n_failed_solves']} failed")
    rel = float(np.max(np.abs(runs["native"] / runs["numpy"] - 1)))
    log(f"3D log natively meshed vs numpy-meshed: readouts agree to {rel:.3e} (limit "
        f"{NATIVE_LOG_REL:g})")
    if not (np.isfinite(runs["native"]).all() and rel <= NATIVE_LOG_REL):
        raise AssertionError(f"native vs numpy 3D log: {rel:.3e}")


def oracle_log(torch, card):
    """Phase 21: tests/test_oracle.py's long lateral over 40 random thin beds
    (seed 11, 0.002 m borehole), 21 depths on the default grid, against the
    layered-medium oracle. Returns K1's launches."""
    from remo3d_tpu_torch import Model
    from remo3d_tpu_torch.tools import parse_tools
    from remo3d_tpu_torch.utils.layered_oracle import layered_apparent_resistivity

    rng = np.random.default_rng(11)
    edges = np.cumsum(rng.uniform(0.12, 0.5, 40)) - 4.0
    rho = rng.uniform(1.5, 9.0, 41)
    formation = np.column_stack([np.concatenate([[-1000.0], edges]),
                                 np.concatenate([edges, [1000.0]]),
                                 np.full(41, np.nan), np.full(41, np.nan), rho])
    borehole = np.array([[-1000.0, 0.002, 4.0], [1000.0, 0.002, 4.0]])
    model, wall, counts, _ = diff_measure(torch, lambda: Model.compute_synthetic_logs(
        [ORACLE_TOOL], ORACLE_DEPTHS, formation, borehole, borehole_geometry_type="radius",
        device="cuda", verbose=False))
    fem = model.logs[ORACLE_TOOL][:, 1]
    tools, _ = parse_tools([ORACLE_TOOL], True)
    tp = tools[ORACLE_TOOL]
    offs = np.concatenate([[0.0], tp.geometry[tp.source_terms == 0]])
    ana = np.array([layered_apparent_resistivity(edges, rho, offs, tp.geometric_factor,
                                                 d + tp.depth_shift) for d in ORACLE_DEPTHS])
    rel = np.abs(fem / ana - 1)
    log(f"oracle on {card}: {ORACLE_TOOL} over 40 thin beds, {len(ORACLE_DEPTHS)} depths in "
        f"{wall:.3f} s, launches {counts}; FEM vs layered oracle max {float(rel.max()):.3e}, "
        f"mean {float(rel.mean()):.3e} (limit {ORACLE_REL:g})")
    if not (np.isfinite(fem).all() and float(rel.max()) <= ORACLE_REL
            and counts["stencil2d_half"] > 0 and model.last_report["n_failed_solves"] == 0):
        raise AssertionError(f"oracle: {float(rel.max()):.3e}, launches {counts}")
    return counts["stencil2d_half"]


def checkpoint_resume(torch, card):
    """Phase 22: phase 4's log in chunks of CKPT_CHUNK, broken in chunk
    CKPT_BREAK_AT by wrapping the chunk solve, resumed, then run a third time.
    Returns K1's launches in the resumed run."""
    from remo3d_tpu_torch.parallel import runtime

    over = {"executor_overrides": {"chunk_size": CKPT_CHUNK}}
    whole, wall, _, _ = diff_measure(torch, lambda: log_2d(torch, DEPTHS, **over))
    ref = readouts_2d(whole)
    n_chunks = len(whole.last_report["chunks"])
    inner = runtime._solve_chunk
    calls = {"n": 0, "fail_at": CKPT_BREAK_AT}

    def wrapped(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == calls["fail_at"]:
            raise RuntimeError("chunk solve broken on purpose")
        return inner(*args, **kwargs)

    runtime._solve_chunk = wrapped
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "phase4.npz")
            try:
                log_2d(torch, DEPTHS, checkpoint=ckpt, **over)
                raise AssertionError("checkpoint: the broken run was not broken")
            except RuntimeError as e:
                if "on purpose" not in str(e):
                    raise
            saved = len(np.load(ckpt)["done_chunks"])
            calls.update(n=0, fail_at=None)
            resumed, wall_r, counts, _ = diff_measure(
                torch, lambda: log_2d(torch, DEPTHS, checkpoint=ckpt, **over))
            n_resumed = calls["n"]
            rel = float(np.max(np.abs(readouts_2d(resumed) / ref - 1)))
            calls["n"] = 0
            third, wall_3, _, _ = diff_measure(
                torch, lambda: log_2d(torch, DEPTHS, checkpoint=ckpt, **over))
            n_third = calls["n"]
            same = np.array_equal(readouts_2d(third), readouts_2d(resumed))
    finally:
        runtime._solve_chunk = inner
    log(f"checkpoint on {card}: unbroken log {n_chunks} chunks in {wall:.3f} s; broken in chunk "
        f"{CKPT_BREAK_AT} with {saved} chunks saved; resumed: {n_resumed} chunk solves in "
        f"{wall_r:.3f} s, launches {counts}, readouts vs unbroken {rel:.3e} (limit "
        f"{CKPT_REL:g}); third run: {n_third} chunk solves in {wall_3:.3f} s, readouts "
        f"{'equal' if same else 'DIFFER'}")
    if not (n_chunks == 4 and saved == CKPT_BREAK_AT - 1 and n_resumed == n_chunks - saved
            and rel <= CKPT_REL and n_third == 0 and same and counts["stencil2d_half"] > 0):
        raise AssertionError(f"checkpoint: {n_chunks} chunks, {saved} saved, {n_resumed} "
                             f"resumed, rel {rel:.3e}, third {n_third}, same {same}")
    return counts["stencil2d_half"]


def profile_traces(torch, card):
    """Phase 23: the first 10 depths of the 2D and 3D logs with profile_dir;
    each trace must exist and name its kernel. Returns launches per kernel."""
    out = {}
    cases = (
        ("2D", "stencil2d_half", lambda d: log_2d(torch, DEPTHS[:10], profile_dir=d)),
        ("3D", "stencil3d_half", lambda d: log_3d(torch, DEPTHS_3D[:10], device="cuda",
                                                  dtype="float32", profile_dir=d)),
    )
    with tempfile.TemporaryDirectory() as tmp:
        for label, kernel, make in cases:
            model, wall, counts, _ = diff_measure(torch, lambda: make(os.path.join(tmp, label)))
            path = model.last_report.get("profile_trace", "")
            text = open(path).read() if os.path.exists(path) else ""
            symbol = f"{kernel}_kernel"
            log(f"profile_dir on {card}: {label} log of 10 depths traced in {wall:.3f} s, "
                f"{os.path.basename(path)} {len(text) / 1e6:.1f} MB, "
                f"{text.count(symbol)} mentions of {symbol}, launches {counts}")
            if not (text and symbol in text and counts[kernel] > 0):
                raise AssertionError(f"profile_dir {label}: no trace naming {symbol}")
            out[kernel] = counts[kernel]
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rank_worker(rank: int, world: int, port: int) -> dict:
    """One rank of phase 24 (``--rank R --world N --port P``). At world size 2:
    (a) phase 4's log in chunks of CKPT_CHUNK and (b) the 4-depth 3D log of one
    batch, each with its wall, launches and report. At world size 1: the 2D
    log of 10 depths and (b) before and after ``initialize_distributed``, which
    must be bitwise equal."""
    import torch

    guard(torch)
    from remo3d_tpu_torch.parallel import distributed

    def run_3d(dtype=RANKS_DTYPE):
        return log_3d(torch, DEPTHS_RANKS_3D, batch_size=4, device="cuda", dtype=dtype)

    if world == 1:
        before = (readouts_2d(log_2d(torch, DEPTHS[:10])), run_3d("float32").logs[TOOLS_3D[0]])
        if not distributed.initialize_distributed(f"localhost:{port}", 1, 0):
            raise AssertionError("initialize_distributed returned False")
        after = (readouts_2d(log_2d(torch, DEPTHS[:10])), run_3d("float32").logs[TOOLS_3D[0]])
        out = {"bitwise": [bool(np.array_equal(a, b)) for a, b in zip(before, after)]}
    else:
        if not distributed.initialize_distributed(f"localhost:{port}", world, rank):
            raise AssertionError("initialize_distributed returned False")
        out = {}
        for case, make, vals in (
            ("a", lambda: log_2d(torch, DEPTHS, RANKS_DTYPE,
                                 executor_overrides={"chunk_size": CKPT_CHUNK}), readouts_2d),
            ("b", run_3d, lambda m: m.logs[TOOLS_3D[0]][:, 1:2]),
        ):
            model, wall, counts, _ = diff_measure(torch, make)
            r = model.last_report
            out[case] = {"readouts": vals(model).tolist(), "wall_s": wall, "launches": counts,
                         "failed": r["n_failed_solves"], "axes": r["axes"], "device": r["device"],
                         "chunks": [c["batches"] for c in r["chunks"]],
                         "solves": [c["solves"] for c in r["chunks"]]}
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return {"rank": rank, "world": world, **out}


def two_ranks(torch, card):
    """Phase 24: two ranks over gloo, both on cuda:0; (a) and (b) against the
    single-process logs; then a rank at world size 1. Returns launches per
    kernel and rank."""
    from concurrent.futures import ThreadPoolExecutor

    model, wall_a, _, _ = diff_measure(torch, lambda: log_2d(
        torch, DEPTHS, RANKS_DTYPE, executor_overrides={"chunk_size": CKPT_CHUNK}))
    ref_2d = readouts_2d(model)
    model, wall_b, _, _ = diff_measure(torch, lambda: log_3d(
        torch, DEPTHS_RANKS_3D, batch_size=4, device="cuda", dtype=RANKS_DTYPE))
    ref_3d = model.logs[TOOLS_3D[0]][:, 1:2]
    log(f"ranks: single-process {RANKS_DTYPE} logs: (a) {len(DEPTHS)} depths in chunks of "
        f"{CKPT_CHUNK} in {wall_a:.3f} s, (b) {len(DEPTHS_RANKS_3D)} depths in one 3D batch in "
        f"{wall_b:.3f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    me = os.path.abspath(__file__)
    limit = GROUP_LIMITS["20-24"] // 3
    port = free_port()
    with ThreadPoolExecutor(2) as pool:
        runs = list(pool.map(lambda r: run_child(
            [sys.executable, me, "--rank", str(r), "--world", "2", "--port", str(port)], limit,
            echo=False), range(2)))
    launches = {"stencil2d_half": {}, "stencil3d_half": {}}
    faults = []
    for r, run in enumerate(runs):
        if run["status"] != "ok":
            log("\n".join(run["tail"]))
            raise AssertionError(f"rank {r} {run['status']} (exit {run['returncode']}) after "
                                 f"{run['seconds']:.1f} s")
        res = run["result"]
        for case, ref, kernel, axes in (("a", ref_2d, "stencil2d_half", {"batch": 2, "solve": 1}),
                                        ("b", ref_3d, "stencil3d_half", {"batch": 1, "solve": 2})):
            c = res[case]
            vals = np.asarray(c["readouts"])
            rel = float(np.max(np.abs(vals / ref - 1)))
            n = c["launches"][kernel]
            launches[kernel][f"launches_rank{r}"] = n
            log(f"rank {r} of 2 on {c['device']} ({card}): ({case}) {vals.shape[0]} depths, "
                f"axes {c['axes']}, batches per chunk {c['chunks']}, solves per chunk "
                f"{c['solves']}, wall {c['wall_s']:.3f} s, launches {c['launches']}, "
                f"{c['failed']} failed solves; vs the single-process log {rel:.3e} (limit "
                f"{RANKS_REL:g})")
            if not (np.isfinite(vals).all() and rel <= RANKS_REL and c["failed"] == 0
                    and n > 0 and c["axes"] == axes):
                faults.append(f"rank {r} ({case}): rel {rel:.3e}, launches {n}, axes {c['axes']}")
    one = run_child([sys.executable, me, "--rank", "0", "--world", "1", "--port",
                     str(free_port())], limit, echo=False)
    if one["status"] != "ok":
        log("\n".join(one["tail"]))
        raise AssertionError(f"world size 1: {one['status']} (exit {one['returncode']})")
    log(f"world size 1: the 2D and 3D logs after initialize_distributed bitwise equal to the "
        f"logs before it: {one['result']['bitwise']} ({one['seconds']:.1f} s)")
    if not all(one["result"]["bitwise"]):
        faults.append(f"world size 1 not bitwise: {one['result']['bitwise']}")
    if faults:
        raise AssertionError("ranks: " + "; ".join(faults))
    return launches


def run_rest(torch, card):
    """Phases 20-24; returns the launch counts per kernel for the kernels line."""
    out = kernel_dicts()
    native_mesher(torch, card)  # 20
    out["stencil2d_half"]["launches_oracle"] = oracle_log(torch, card)  # 21
    out["stencil2d_half"]["launches_resume"] = checkpoint_resume(torch, card)  # 22
    for kernel, n in profile_traces(torch, card).items():  # 23
        out[kernel]["launches_profile"] = n
    for kernel, d in two_ranks(torch, card).items():  # 24
        out[kernel].update(d)
    return out


def counted(torch, out: dict, key: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with the kernels' counts set to 0 just before
    and read just after: they go into ``out[kernel]["launches_" + key]``."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    torch.cuda.synchronize()
    counts = read_counts()
    for kernel, n in counts.items():
        out[kernel][f"launches_{key}"] = n
    log(f"{key}: {time.perf_counter() - t0:.1f} s, launches {counts}")
    return result


def c2_on_card(torch, card, out):
    """Phase 25: the float32 2D log of phase 4 (multigrid, the CUDA default)
    against float64 (direct, tol 1e-10), held to the JAX package's spread of
    the same workload; the 3D and the potential spreads beside the JAX
    package's README figures."""
    from remo3d_tpu_torch.validation import arithmetic_parity

    s = counted(torch, out, "ra2d", arithmetic_parity.ra2d, device="cuda")
    log(f"C2 on {card}: float32 multigrid vs float64 direct, {len(DEPTHS)} depths x "
        f"{len(EXAMPLE01_TOOLS)} tools: max {s['max']:.3e} (limit {C2_MAX:g}), rms "
        f"{s['rms']:.4e} (limit {C2_RMS:g}); per tool " + ", ".join(
            f"{t} {v:.3e} / rms {float(np.sqrt(np.mean(s['rel'][:, i] ** 2))):.3e}"
            for i, (t, v) in enumerate(zip(EXAMPLE01_TOOLS, s["per_tool"]))))
    s3 = counted(torch, out, "ra3d", arithmetic_parity.ra3d, device="cuda")
    log(f"ra3d on {card}: BM3 dip 30, float32 vs float64 (direct): max {s3['max']:.3e} "
        f"(the JAX package: {JAX_RA3D:g})")
    u_max, u_mean = counted(torch, out, "u2d", arithmetic_parity.u2d, device="cuda")
    log(f"u2d on {card}: axis potentials float32 vs float64: max {u_max:.2e}, mean "
        f"{u_mean:.2e} (the JAX package: {JAX_U2D[0]:g} / {JAX_U2D[1]:g})")
    if not (s["max"] <= C2_MAX and s["rms"] <= C2_RMS):
        raise AssertionError(f"C2: spread max {s['max']:.3e}, rms {s['rms']:.3e}")


def run_examples(torch, card, out):
    """Phase 26: examples 01-05 through their ``main`` on the card, each
    results file read back (inside the examples), the inversions within 0.1%."""
    from remo3d_tpu_torch.examples import (
        example_01,
        example_02,
        example_03_dip,
        example_04_inversion,
        example_05_dip_inversion,
    )

    with tempfile.TemporaryDirectory() as tmp:
        for key, fn, kernel in ((("ex01", example_01.main, "stencil2d_half"),
                                 ("ex02", example_02.main, "stencil2d_half"),
                                 ("ex03", example_03_dip.main, "stencil3d_half"))):
            model, folder = counted(torch, out, key, fn, output_folder=os.path.join(tmp, key),
                                    device="cuda")
            vals = np.concatenate([v[:, 1] for v in model.logs.values()])
            log(f"{key} on {card}: {len(vals)} readouts, {model.last_report['n_failed_solves']} "
                f"failed solves, chunks {len(model.last_report['chunks'])}, Ra "
                f"{np.nanmin(vals):.3f}..{np.nanmax(vals):.3f}")
            if not np.isfinite(vals).all() or out[kernel][f"launches_{key}"] == 0:
                raise AssertionError(f"{key}: {int((~np.isfinite(vals)).sum())} non-finite "
                                     f"readouts, {kernel} launches {out[kernel]}")
    faults = []
    for key, fn in (("ex04", example_04_inversion.main), ("ex05", example_05_dip_inversion.main)):
        r = counted(torch, out, key, fn, device="cuda")
        log(f"{key} on {card}: {r['iterations']} iterations, rms log-misfit {r['misfit']:.2e}, "
            f"worst parameter error {r['worst']:.4%} (limit {INVERSION_WORST:.1%})")
        if not (r["misfit"] < INVERSION_MISFIT and r["worst"] < INVERSION_WORST):
            faults.append(f"{key}: misfit {r['misfit']:.2e}, worst {r['worst']:.3%}")
    if faults:
        raise AssertionError("; ".join(faults))


def run_validation(torch, card, out):
    """Phase 27: the oracle scripts on the card (the FV oracle on the host's
    cores), each number beside the JAX package's README figure."""
    from remo3d_tpu_torch.validation import bm2_dip_oracle, bm2_oracle, bm3_oracle, oracle_sweep

    faults = []
    worst = counted(torch, out, "bm3_oracle", bm3_oracle.main, device="cuda")
    for dip, w in worst.items():
        log(f"bm3_oracle on {card}: dip {dip}: worst {w:.3%} (limit {BM3_ORACLE_REL[dip]:.1%}; the "
            f"JAX package: {JAX_BM3[dip]})")
        if not w <= BM3_ORACLE_REL[dip]:
            faults.append(f"bm3_oracle dip {dip}: {w:.3%}")
    w = counted(torch, out, "bm2_oracle", bm2_oracle.main, device="cuda")
    log(f"bm2_oracle on {card}: worst {w:.3%} (limit {FV_ORACLE_REL:.1%}; the JAX package: 0.19%)")
    if not w <= FV_ORACLE_REL:
        faults.append(f"bm2_oracle: {w:.3%}")
    rows = counted(torch, out, "oracle_sweep", oracle_sweep.main, quick=True, device="cuda")
    w = max(r[2] for r in rows)
    log(f"oracle_sweep --quick on {card}: worst {w:.3%} (limit {FV_ORACLE_REL:.1%}; the JAX "
        f"package: 0.16% over its full sweep)")
    if not w <= FV_ORACLE_REL:
        faults.append(f"oracle_sweep: {w:.3%}")
    r = counted(torch, out, "bm2_dip_oracle", bm2_dip_oracle.main, device="cuda")
    log(f"bm2_dip_oracle on {card}: 2D vs FV {r['fv_worst']:.3%} (limit {BM2_DIP_FV_REL:.1%}; the "
        f"JAX package: 0.21%), 3D at dip->0 vs 2D max {r['gap_max']:.3%} (limit "
        f"{BM2_DIP_GAP:.0%}; the JAX package: 2.35%), mean {r['gap_mean']:.3%}")
    if not (r["fv_worst"] <= BM2_DIP_FV_REL and r["gap_max"] <= BM2_DIP_GAP):
        faults.append(f"bm2_dip_oracle: {r['fv_worst']:.3%}, {r['gap_max']:.3%}")
    if faults:  # after every script ran
        raise AssertionError("validation: " + "; ".join(faults))


def run_parity(torch, card, out):
    """Phase 28: float64 potentials on the card against the FV oracle at one
    BM1-like source depth, the 1x / 2x / 4x refinement ladder, then the
    benchmark-model dip ladder NaN-free."""
    from remo3d_tpu_torch.validation import bm_models, potential_parity

    w = counted(torch, out, "potential_oracle", potential_parity.run_oracle, "BM1-like",
                [potential_parity.CONVERGE_DEPTH], device="cuda")
    log(f"potential_parity on {card}: float64 FEM vs FV {w:.2e} (limit {POTENTIAL_FV_REL:g}; the "
        f"JAX package: 5.5e-3 over its sweep)")
    c = counted(torch, out, "potential_converge", potential_parity.run_converge, device="cuda")
    lo, hi = float(np.min(c["order"])), float(np.max(c["order"]))
    log(f"potential_parity on {card}: observed order {lo:.3f}..{hi:.3f} (limits {ORDER_RANGE}; "
        f"the JAX package: 2.08), deltas {c['deltas']}, remaining at 4x "
        f"{float(np.max(c['remaining'])):.2e}")
    counted(torch, out, "bm_models", bm_models.run_bm3, device="cuda")
    if not (w <= POTENTIAL_FV_REL and ORDER_RANGE[0] <= lo and hi <= ORDER_RANGE[1]):
        raise AssertionError(f"potential parity: FV {w:.2e}, order {lo:.3f}..{hi:.3f}")


def run_scripts(torch, card):
    """Phases 25-28; returns the launch counts per kernel and script. A gate
    that fails is raised after the last phase, with every other one."""
    out = kernel_dicts()
    faults = []
    for phase in (c2_on_card, run_examples, run_validation, run_parity):  # 25, 26, 27, 28
        try:
            phase(torch, card, out)
        except AssertionError as e:
            log(f"FAILED {phase.__name__}: {e}")
            faults.append(str(e))
    if faults:
        raise AssertionError("phases 25-28: " + "; ".join(faults))
    return out


def k3_shapes() -> list:
    """(label, B, S or None, grid, axis) of every K3 launch of phases 4 and 8:
    per multigrid level of the 2D log its z and r lines, on the chunk's S
    solves and (the power iterations) on one vector per batch; the 3D
    chunk's z, p and r lines."""
    from remo3d_tpu_torch.parallel.runtime import _feasible_mg_levels

    (B, S), (nz, nr) = K3_2D_BS, K3_2D_GRID
    out = []
    for lvl in range(_feasible_mg_levels(nz, nr)):
        grid = ((nz - 1) // 2**lvl + 1, (nr - 1) // 2**lvl + 1)
        for d, axis in (("z", -2), ("r", -1)):
            out.append((f"2D level {lvl} {d}", B, S, grid, axis))
            out.append((f"2D level {lvl} {d}, power iteration", B, None, grid, axis))
    B, S, *grid = K3_3D_SHAPE
    for d, axis in (("z", -3), ("p", -2), ("r", -1)):
        out.append((f"3D {d}", B, S, tuple(grid), axis))
    return out


def check_k3(torch, card):
    """Phase 30: K3 against its plain version at every shape of
    :func:`k3_shapes`, float32 and float64, on random diagonally dominant
    lines (an M-matrix, as the FEM operators' lines are); each timed (median
    of 25 CUDA-event timings, interleaved with the plain version) beside its
    bound (``pcr_lines.least_work``): b read and x written once per solve, the
    coefficients that the function reads once per batch (alpha_k at i >= s,
    beta_k at i < n - s, then dinv); 4 flops per coefficient term and solve,
    and one for dinv.
    Returns a row per shape and type; the first (2D finest z lines,
    float32) is the kernels line's."""
    from remo3d_tpu_torch.kernels import pcr_lines
    from remo3d_tpu_torch.ops.lines import pcr_factor_stacked

    rng = np.random.default_rng(2024)
    rows, faults = [], []
    for label, B, S, grid, axis in k3_shapes():
        shape = (B, *grid)
        dl, du = -rng.uniform(0.1, 1.0, shape), -rng.uniform(0.1, 1.0, shape)
        d = -(dl + du) + rng.uniform(0.05, 0.5, shape)
        b64 = rng.standard_normal(shape if S is None else (B, S, *grid))
        for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            F = pcr_factor_stacked(*(torch.as_tensor(a, device="cuda").to(dt) for a in (dl, d, du)),
                                   axis=axis, stack_dim=1)
            b = torch.as_tensor(b64, device="cuda").to(dt)
            x_k = pcr_lines.pcr_apply_lines(F, b, axis)
            x_p = pcr_lines.pcr_apply_lines_plain(F, b, axis)
            torch.cuda.synchronize()
            err = float((x_k - x_p).abs().max())
            rel = err / float(x_p.abs().max())
            for _ in range(3):  # warm-up
                pcr_lines.pcr_apply_lines(F, b, axis)
                pcr_lines.pcr_apply_lines_plain(F, b, axis)
            k_ms, p_ms = [], []
            for _ in range(25):
                p_ms.append(time_ms(torch, lambda: pcr_lines.pcr_apply_lines_plain(F, b, axis)))
                k_ms.append(time_ms(torch, lambda: pcr_lines.pcr_apply_lines(F, b, axis)))
            k, p = float(np.median(k_ms)), float(np.median(p_ms))
            L, solves = (F.shape[1] - 1) // 2, S or 1
            n_bytes, flops = map(float, pcr_lines.least_work(B, solves, grid, axis, L,
                                                             F.element_size()))
            b_ms, b_by = bound_ms(n_bytes, flops, name)
            info = pcr_lines.kernel_info(B, solves, grid, axis, L, dt)
            row = {"shape": label, "b": list(b.shape), "axis": axis, "levels": L, "dtype": name,
                   "max_abs_err": err, "rel_err": rel, "ms": k, "plain_ms": p, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None, **info}
            rows.append(row)
            log(f"K3 {label} {name} b {tuple(b.shape)} axis {axis}, L = {L}: max|kernel-plain| = "
                f"{err:.3e}, relative to max|x| {rel:.3e} (tolerance {TOL_REL[name]:g}); kernel "
                f"{k:.4f} ms, plain {p:.4f} ms (median of 25); bound {b_ms:.4f} ms by {b_by} "
                f"({n_bytes / 1e6:.1f} MB): kernel at {b_ms / k:.1%} of it, "
                f"{n_bytes / (k * 1e-3) / 1e9:.0f} GB/s; {info['registers']} registers, "
                f"{info['spill_bytes']} B spilled, {info['smem_bytes']} B shared memory per "
                f"block, {info['blocks_per_sm']} blocks of 256 threads per SM; plan: "
                f"{info['TO']} x {info['TI']} lines per tile ({info['tiles_o']} x "
                f"{info['tiles_i']} tiles), cluster {info['cluster']} ({info['seg']} nodes of a "
                f"line per block), {info['stages']} coefficient stages ({card})")
            if not rel <= TOL_REL[name]:
                faults.append(f"{label} {name}: rel err {rel:.3e} > {TOL_REL[name]}")
            if info["blocks_per_sm"] < 1:
                faults.append(f"{label} {name}: no block fits an SM")
            del F, b, x_k, x_p
        torch.cuda.empty_cache()
    if faults:  # after every shape was printed
        raise AssertionError("K3: " + "; ".join(faults))
    return rows


# Phase 30: the ADI sweep's damped step at both 3D cells' chunks (the
# benchmark's bm2_dip60 and bm3_dip30: 8 batches of 5 solves).
K3_STEP_SHAPES = [(8, 5, 257, 25, 65), (8, 5, 193, 17, 49)]
K3_STEP_SCALE = 0.6  # the sweep's adi_damp


def check_k3_step(torch, card):
    """Phase 30: the sweep's damped step z <- z + w P(T^-1 res) at
    :data:`K3_STEP_SHAPES`, per line direction, float32: K3 with the step
    epilogue writing z in place, then the tie of the axis column
    (``pole_tie_``), against the unfused step (K3, the projection's copy, the
    scalar multiply and the add): bit-equal off the axis column, within
    TOL_POLE of max|z| on it. Each timed (median of 25 CUDA-event timings,
    interleaved), with the fused launch alone and K3 alone beside them, and
    the epilogue's registers. Returns a row per shape and direction."""
    from remo3d_tpu_torch.kernels import pcr_lines
    from remo3d_tpu_torch.ops.lines import pcr_factor_stacked
    from remo3d_tpu_torch.ops.stencil3d import pole_project, pole_tie_

    rng = np.random.default_rng(2026)
    w = K3_STEP_SCALE
    rows, faults = [], []
    for B, S, *grid in K3_STEP_SHAPES:
        for d, axis in (("z", -3), ("p", -2), ("r", -1)):
            shape = (B, *grid)
            dl, du = -rng.uniform(0.1, 1.0, shape), -rng.uniform(0.1, 1.0, shape)
            dd = -(dl + du) + rng.uniform(0.05, 0.5, shape)
            F = pcr_factor_stacked(*(torch.as_tensor(a, device="cuda").float() for a in (dl, dd, du)),
                                   axis=axis, stack_dim=1)
            del dl, du, dd
            res = torch.randn((B, S, *grid), device="cuda")
            z0 = pole_project(torch.randn((B, S, *grid), device="cuda"))

            def unfused():
                return z0 + w * pole_project(pcr_lines.pcr_apply_lines(F, res, axis))

            z = z0.clone()

            def fused():
                return pole_tie_(pcr_lines.pcr_apply_lines(F, res, axis, scale=w, base=z, out=z))

            ref, got = unfused(), fused()
            torch.cuda.synchronize()
            off_axis = torch.equal(got[..., 1:], ref[..., 1:])
            rel = float((got - ref).abs().max()) / float(ref.abs().max())
            times = {"unfused": [], "fused": [], "fused_k3": [], "k3": []}
            fns = {"unfused": unfused, "fused": fused,
                   "fused_k3": lambda: pcr_lines.pcr_apply_lines(F, res, axis, scale=w, base=z,
                                                                 out=z),
                   "k3": lambda: pcr_lines.pcr_apply_lines(F, res, axis)}
            for fn in fns.values():  # warm-up (z drifts; only the timings follow)
                fn()
            for _ in range(25):
                for key, fn in fns.items():
                    times[key].append(time_ms(torch, fn))
            ms = {k: float(np.median(v)) for k, v in times.items()}
            L = (F.shape[1] - 1) // 2
            info = pcr_lines.kernel_info(B, S, grid, axis, L, torch.float32, step=True)
            label = f"({B},{S},{'x'.join(map(str, grid))}) {d}"
            rows.append({"shape": label, "axis": axis, "off_axis_bit_equal": off_axis,
                         "rel_err": rel, **{f"{k}_ms": v for k, v in ms.items()},
                         "registers": info["registers"], "spill_bytes": info["spill_bytes"],
                         "cluster": info["cluster"]})
            log(f"K3 step {label}: fused (K3 with the epilogue, in place, + the axis tie) "
                f"{ms['fused']:.4f} ms against unfused (K3 + copy + multiply + add) "
                f"{ms['unfused']:.4f} ms ({ms['unfused'] / ms['fused']:.2f}x); the fused launch "
                f"{ms['fused_k3']:.4f} ms, K3 alone {ms['k3']:.4f} ms; off the axis column "
                f"bit-equal {off_axis}, max|fused-unfused| / max|z| {rel:.3e}; epilogue "
                f"{info['registers']} registers, {info['spill_bytes']} B spilled, cluster "
                f"{info['cluster']} ({card})")
            if not (off_axis and rel <= TOL_POLE["float32"]):
                faults.append(f"step {label}: off-axis equal {off_axis}, rel {rel:.3e}")
            del F, res, z0, z, ref, got
            torch.cuda.empty_cache()
    if faults:
        raise AssertionError("K3 step: " + "; ".join(faults))
    return rows


def k3_off(fn):
    """``fn()`` with K3 off (``ops.lines.PCR_KERNEL``): the line solves
    through the plain ``pcr_apply`` on the card."""
    from remo3d_tpu_torch.ops import lines

    lines.PCR_KERNEL = False
    try:
        return fn()
    finally:
        lines.PCR_KERNEL = True


def k3_on_off(torch, card, label, make_log, readouts, rel_gate, per_iteration) -> dict:
    """Phases 31 and 32: ``make_log()`` with K3 off, on, on with the CG loop
    op by op, and off again, each counted like the main path. K3 on against
    the first run off: readouts within ``rel_gate`` (relative), CG iterations
    per chunk within 1; K3 launched at least ``per_iteration`` times per CG
    iteration with it on, never with it off; on against op by op as in phase
    4. Returns the launch counts and walls for the kernels line."""
    runs = {}
    for key, wrap in (("off", k3_off), ("on", lambda f: f()), ("on, op by op", eager),
                      ("off again", k3_off)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        model = wrap(make_log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        report = model.last_report
        runs[key] = {"vals": readouts(model), "launches": read_counts(), "wall": wall,
                     "iterations": [c["iterations"] for c in report["chunks"]]}
        log(f"{label} on {card}, K3 {key}: {wall:.3f} s, CG iterations "
            f"{runs[key]['iterations']}, launches {runs[key]['launches']}; phases "
            + ", ".join(f"{k} {v:.3f} s" for k, v in report["phases"].items())
            + f"; {graph_figures(report)}")
    on, off = runs["on"], runs["off"]
    faults = graph_vs_eager(f"{label} with K3", on, runs["on, op by op"])
    rel = float(np.max(np.abs(on["vals"] / off["vals"] - 1)))
    log(f"{label}: K3 on against off: readouts {rel:.3e} (limit {rel_gate:g}), CG iterations "
        f"{on['iterations']} / {off['iterations']}, K3 launches {on['launches']['pcr_lines']} / "
        f"{off['launches']['pcr_lines']}; wall {on['wall']:.3f} s on against "
        f"{off['wall']:.3f} / {runs['off again']['wall']:.3f} s off")
    if not (np.isfinite(on["vals"]).all() and rel <= rel_gate):
        faults.append(f"{label}: K3 on vs off readouts {rel:.3e} > {rel_gate}")
    if len(on["iterations"]) != len(off["iterations"]) or any(
            abs(a - b) > 1 for a, b in zip(on["iterations"], off["iterations"])):
        faults.append(f"{label}: CG iterations {on['iterations']} on, {off['iterations']} off")
    if on["launches"]["pcr_lines"] < per_iteration * sum(on["iterations"]):
        faults.append(f"{label}: K3 launched {on['launches']['pcr_lines']} times for CG "
                      f"iterations {on['iterations']}")
    if off["launches"]["pcr_lines"] or runs["off again"]["launches"]["pcr_lines"]:
        faults.append(f"{label}: K3 launched with it off")
    if faults:
        raise AssertionError("; ".join(faults))
    return {"launches": on["launches"]["pcr_lines"], "wall_on_s": on["wall"],
            "wall_off_s": [off["wall"], runs["off again"]["wall"]]}


def run_k3(torch, card) -> dict:
    """Phases 30-32."""
    rows = check_k3(torch, card)  # 30
    steps = check_k3_step(torch, card)
    logs = {
        "2d": k3_on_off(torch, card, "2D log (phase 31)", lambda: log_2d(torch, DEPTHS),
                        readouts_2d, LOG_REL, 2),
        "3d": k3_on_off(torch, card, "3D log (phase 32)",
                        lambda: log_3d(torch, DEPTHS_3D, device="cuda", dtype="float32"),
                        lambda m: m.logs[TOOLS_3D[0]][:, 1], LOG3D_REL_PAIR, 5),
    }
    return {"shapes": rows, "steps": steps, "logs": logs}


def check_checkout(torch):
    """Every process of this script: a card is visible, the package is this
    checkout's, JAX was not imported."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import remo3d_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(remo3d_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != REPO:
        raise SystemExit(f"chip_smoke: remo3d_tpu_torch imported from {pkg_dir}, not this checkout")
    if any(m.split(".")[0] in ("jax", "remo3d_tpu") for m in sys.modules):
        raise SystemExit("chip_smoke: JAX was imported")


def guard(torch):
    """A child: :func:`check_checkout`, then the kernel library is loaded."""
    check_checkout(torch)
    from remo3d_tpu_torch.kernels import build

    torch.cuda.set_device(torch.device("cuda:0"))
    return build.load_library()


def run_group(group: str) -> dict:
    """A child: one phase group (or mode) on the card; returns its results."""
    import torch

    guard(torch)
    card = card_line()
    if group == "3-6":
        info = report_kernel_info(torch)  # 2: what the built kernels use
        k1 = check_k1(torch)  # 3
        k1["launches"], k3 = run_2d(torch, card)  # 4-6
        return {"k1": k1, "launches_pcr_2d": k3,
                "info": {"stencil2d_half": info["K1 float32 S=5 NR=161"],
                         "stencil3d_half": info["K2 float32 S=5 NPxNR=17x49"]}}
    if group == "7-11":
        k2 = check_k2(torch)  # 7
        k2["launches"], k3 = run_3d(torch, card)  # 8-11
        return {"k2": k2, "launches_pcr_3d": k3}
    if group == "12-15":
        return {"screen": run_screen(torch, card)}
    if group == "16-19":
        timings, launches = run_diff(torch, card)
        return {"contraction": timings, "launches": launches}
    if group == "20-24":
        return {"launches": run_rest(torch, card)}
    if group == "25-28":
        return {"launches": run_scripts(torch, card)}
    if group == "30-32":
        return {"k3": run_k3(torch, card)}
    {"profile-direct": profile_direct, "tune-direct": tune_direct, "tune": tune,
     "probe": probe}[group](torch, card)
    return {}


def main() -> int:
    import signal

    signal.signal(signal.SIGTERM, _end_children)
    args = sys.argv[1:]
    if args[:1] == ["--phase"] and len(args) == 2:
        result = run_group(args[1])
        print(json.dumps({"group": args[1], **result}))
        return 0
    if args[:1] == ["--rank"] and len(args) == 6:
        rank, world, port = int(args[1]), int(args[3]), int(args[5])
        print(json.dumps(rank_worker(rank, world, port)))
        return 0
    if args and (len(args) > 1 or args[0] not in MODES):
        raise SystemExit(f"chip_smoke: unknown arguments {args}")
    groups = [MODES[args[0]]] if args else GROUPS

    # ---- 1. card -----------------------------------------------------------------
    import torch

    check_checkout(torch)
    from remo3d_tpu_torch.kernels import build
    from remo3d_tpu_torch.meshing import native

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    if gxx.returncode != 0:
        raise SystemExit("chip_smoke: no g++ for the native mesher")
    log(f"g++: {gxx.stdout.splitlines()[0]}")

    # ---- 2. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_library()
    log(f"build: {build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    if build.build_log_path().exists():
        for line in build.build_log_path().read_text().splitlines():
            if "Compiling entry function" in line or "Used" in line or "spill" in line:
                log("ptxas: " + line.strip())
    t0 = time.perf_counter()
    if not native.native_available():
        raise SystemExit(f"chip_smoke: the native mesher does not build: {native.load_error()}")
    log(f"build: {native.library_path().name} (native mesher) in {time.perf_counter() - t0:.1f} s")

    # ---- the phase groups, each in a child under its limit ------------------------------
    t_start = time.perf_counter()
    results = {}
    for g in groups:
        run = run_child([sys.executable, os.path.abspath(__file__), "--phase", g], GROUP_LIMITS[g])
        if run["status"] == "cut":
            log(f"chip_smoke: phase group {g} cut after {run['seconds']:.1f} s (limit "
                f"{GROUP_LIMITS[g]} s, exit {run['returncode']})")
            return 1
        if run["status"] != "ok":
            log(f"chip_smoke: phase group {g} failed (exit {run['returncode']}) after "
                f"{run['seconds']:.1f} s; its last lines:")
            log("\n".join(run["tail"][-8:]))
            return 1
        results[g] = run["result"]
        log(f"phase group {g} done in {run['seconds']:.1f} s (limit {GROUP_LIMITS[g]} s), "
            f"{time.perf_counter() - t_start:.1f} s in all")

    if args:
        payload = {k: v for k, v in results[groups[0]].items() if k != "group"}
        log(card)
        if payload:
            print(json.dumps(payload))
        return 0
    k1, k2 = results["3-6"]["k1"], results["7-11"]["k2"]
    rows = results["12-15"]["screen"]
    log(json.dumps({"screen": rows}))
    for k, name in ((k1, "stencil2d_half"), (k2, "stencil3d_half")):
        dim = "2D" if name == "stencil2d_half" else "3D"
        for schedule in ("bcr", "scan"):  # the first full-depth run of each
            row = next(r for r in rows
                       if r["dim"] == dim and r["preconditioner"] == f"direct-{schedule}")
            k[f"launches_direct_{schedule}"] = row["launches"][name]
    log(json.dumps({"contraction": results["16-19"]["contraction"]}))
    k1.update(results["16-19"]["launches"]["stencil2d_half"])
    k2.update(results["16-19"]["launches"]["stencil3d_half"])
    for g in ("20-24", "25-28"):
        k1.update(results[g]["launches"]["stencil2d_half"])
        k2.update(results[g]["launches"]["stencil3d_half"])
    k3_run = results["30-32"]["k3"]
    main = k3_run["shapes"][0]  # 2D finest z lines, float32
    k3 = {key: main[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}
    k3["launches_pcr_2d"] = results["3-6"]["launches_pcr_2d"]
    k3["launches_pcr_3d"] = results["7-11"]["launches_pcr_3d"]
    k3["launches"] = k3["launches_pcr_2d"] + k3["launches_pcr_3d"]
    for dim, row in k3_run["logs"].items():
        k3[f"launches_pcr_on_off_{dim}"] = row["launches"]
    for row in rows:  # the iterative preconditioners' first, graphed runs
        if row["preconditioner"] in ("multigrid", "adi") and row["cg_loop"] == "graph":
            k3.setdefault(f"launches_screen_{row['preconditioner']}", row["launches"]["pcr_lines"])
    for g in ("20-24", "25-28"):
        k3.update(results[g]["launches"]["pcr_lines"])
    k3["shapes"] = [{key: r[key] for key in ("shape", "b", "axis", "dtype", "ms", "plain_ms",
                                             "bound_ms", "rel_err", "registers", "smem_bytes",
                                             "tile_rows", "blocks_per_sm", "TO", "TI",
                                             "cluster", "seg", "stages")}
                    for r in k3_run["shapes"]]
    k3["steps"] = k3_run["steps"]

    log("kernel resources at the main shapes: " + json.dumps(results["3-6"]["info"]))
    log(card)
    print(json.dumps({"kernels": [
        {
            "name": "stencil2d_half",
            "route": "cuda",
            "source": "remo3d_tpu_torch/csrc/stencil2d.cu",
            "replaces": "remo3d_tpu/ops/pallas_stencil2d.py:69",
            **k1,
        },
        {
            "name": "stencil3d_half",
            "route": "cuda",
            "source": "remo3d_tpu_torch/csrc/stencil3d.cu",
            "replaces": "remo3d_tpu/ops/pallas_stencil.py:191",
            **k2,
        },
        {
            "name": "pcr_lines",
            "route": "cuda",
            "source": "remo3d_tpu_torch/csrc/pcr_lines.cu",
            "replaces": "remo3d_tpu/ops/pallas_lines2d.py:116 and "
                        "remo3d_tpu/ops/pallas_lines3d.py:74 at 9fd23cb^ (removed; today "
                        "remo3d_tpu/ops/lines.py:111)",
            "redesigned": "PR 14",
            **k3,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
