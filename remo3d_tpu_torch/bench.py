# -*- coding: utf-8 -*-
"""Benchmark of the PyTorch port on one CUDA card: the 3D north-star log and
the 2D throughput of the repository's ``bench.py``, with their spread, the
solve phase's share of the HBM rate, the kernels' launches and a float64 spot
check.

    python -m remo3d_tpu_torch.bench [--repeats 5] [--limit 600]
        [--formation-2d F --borehole-2d B] [--formation-3d F --borehole-3d B]

Prints ONE JSON line with ``bench.py``'s fields ({"metric", "value", "unit",
"vs_baseline", ...}) and exits 0, or 1 when a workload failed, ran out of
time or failed a check (then ``ok`` is false and ``failures`` says why).

Workloads, each through the public ``Model`` on the CUDA defaults
(``preconditioner="auto"``: multigrid in 2D and ADI in 3D; device meshing in
2D; float32):

* 3D: Benchmark model 3 at dip 30, one lateral tool, 100 depths 5..29.75 m
  on the default 193x17x49 grid; points/s is the primary metric (the
  reference takes 15-30 min for it on an AMD Ryzen 2600, 0.074 points/s);
* 2D: Example_01's six tools, 101 depths 0..10 m on the default 761x161
  grid; readouts/s (the reference: ~5 single-tool points/s) and solves/s.

Without files each runs the inline model of
:mod:`remo3d_tpu_torch.validation.models` (BM3 and the BM2-like invaded
formation); the reference's files are taken as ``--formation-3d`` /
``--borehole-3d`` and ``--formation-2d`` / ``--borehole-2d`` (borehole files
hold diameters, as the reference's do).

Each workload runs in a child process (``--workload 3d|2d``) under ``timeout
-k 10 <--limit>``: one full-size warm-up call (the kernels' build and CUDA's
set-up, reported as ``warmup_*_s``), ``--repeats`` timed calls, each ending in
``torch.cuda.synchronize()`` (rates and walls are their medians; ``runs_*_s``
lists every wall), one more call under ``torch.profiler`` for the ``layers``
numbers (never timed), and the spot check: 3 depths of the log in float32 on
the timed route against float64 through the direct preconditioner on the same
card. The parent prints the line whatever the children did.

``--cpu`` (for the tests only) runs the workloads on the CPU, on the grids
of ``--grid-2d`` / ``--grid-3d`` and the first ``--n-depths`` depths; then
``device`` is "cpu" and every device metric (``bw_util_*``, the profiler's
numbers, peak memory) is null. Without ``--cpu`` and without a card the
bench exits nonzero; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .examples.common import launches, launches_since
from .kernels.pcr_lines import coefficient_values
from .meshing.grid2d import GridSpec2D
from .meshing.grid3d import GridSpec3D
from .model import Model
from .ops import lines
from .ops.lines import _n_steps
from .parallel.runtime import _feasible_mg_levels
from .validation.models import (
    BM2_BOREHOLE,
    BM2_FORMATION,
    BM3_BOREHOLE,
    BM3_FORMATION,
    EXAMPLE01_TOOLS,
    model_tables,
)

# The reference's CPU figures (its README: 100 points in 15-30 min in 3D,
# 100 single-tool points in 15-30 s in 2D; midpoints).
REFERENCE_3D_POINTS_PER_S = 0.074
REFERENCE_2D_POINTS_PER_S = 5.0
# The published HBM3 rate of the NVIDIA H100 SXM (NVIDIA's data sheet), B/s.
H100_SXM_HBM_BYTES_PER_S = 3.35e12

WORKLOADS = ("3d", "2d")
TOOLS_3D = ["A2.0M0.5N"]
DEPTHS_3D = np.arange(5.0, 29.76, 0.25)  # 100 measurement points
DIP_3D = 30
DEPTHS_2D = np.arange(0, 25.1, 0.1)[:101]  # bench.py's BENCH_DEPTHS default
# The spot check: float32 against float64 (direct, tol 1e-10) at 3 depths.
# 2D: the JAX package's float32-vs-float64 spread of the 101-depth log (max);
# 3D: the gate of the 3D logs (PERF.md section 2).
SPOT_REL = {"2d": 3.19e-4, "3d": 1e-3}
SPOT_TOL64 = 1e-10
# A converged lane stops at |r| <= tol |b|; the residual reported is that
# ratio recomputed in the working dtype, which may round a few ulps above tol.
RESIDUAL_ROUNDING = 1e-5
TOP_KERNELS = 5
KERNEL_NAME_CHARS = 120  # kernel names are cut here (templates run to 1000s)


# ----------------------------------------------------------------------------------
# The traffic model: the least HBM bytes of a chunk's solve, per route.
#
# Every pass that the route runs (an operator apply, a PCR level, a vector
# update, a dot product) reads each array it takes once and writes each array
# it makes once; allocations of zeros and scalar results are free, and no
# array is taken to stay in the L2 cache from one pass to the next. With B
# batches (the chunk, padding included), S solve slots and N grid nodes, a
# coefficient plane is P = B*N*itemsize bytes, a vector of all solves
# V = S*P, and a Dirichlet mask B*N bytes (bool).
# ----------------------------------------------------------------------------------


def _pcr_apply(k: int, vec: int, plane: int, n: int, kernel: bool = False) -> int:
    """A factored PCR line apply of k levels on lines of n nodes: per level x,
    alpha, beta read and x written; then x * dinv. With K3 (``kernel``), its
    least bytes: b read and x written once, and of each line the coefficients
    that the function reads (``pcr_lines.coefficient_values``) once."""
    if kernel:
        return 2 * vec + plane // n * coefficient_values(n, k)
    return k * (2 * vec + 2 * plane) + 2 * vec + plane


def _pcr_factor(k: int, plane: int) -> int:
    """A PCR factorization of k levels: per level a, c, d read and alpha,
    beta, a, c, d written; then dinv from d."""
    return (8 * k + 2) * plane


def _cg(iterations: int, vec: int, matvec: int, precond: int) -> int:
    """Preconditioned CG (``ops/cg.py``): |b|^2, M^-1 b and r.z before the loop;
    per iteration r.r, the matvec, p.Ap, the u and r updates, M^-1 r, r.z and
    the p update; r.r at the exit and the final residual."""
    return 4 * vec + precond + iterations * (matvec + 14 * vec + precond) + vec


def _blocks_bcr(m: int) -> int:
    """Dense blocks that cyclic reduction stores for m diagonal blocks
    (``block_bcr.bcr_factor_dense``): per level the odd G's and both halves of
    the couplings, then the root inverse."""
    blocks = 1
    while m > 1:
        blocks += m // 2 + (m - 1)
        m = (m + 1) // 2
    return blocks


def _load_2d(B, S, nz, nr, f):
    """Assembly (coords and sigma read, the 9-plane stencil written), the
    Dirichlet elimination, and the singularity-subtracted load with its lift."""
    n = nz * nr
    p, v, m = B * n * f, S * B * n * f, B * n
    cells = B * (nz - 1) * (nr - 1) * f
    assembly = 2 * p + cells + 9 * p
    dirichlet = 9 * p + m + 9 * p
    load = (2 * p + v) + (2 * p + cells + v) + (v + m + v) + (9 * p + 2 * v) + 3 * v + (2 * v + m)
    return assembly + dirichlet + load + 4 * v  # + u = w + g_lift + u_s


def traffic_multigrid_2d(B, S, nz, nr, iterations, *, itemsize=4, n_levels=4, degree=2,
                         coarse_degree=24, power_iters=6, kernel_levels=2, line_steps=None,
                         pcr_kernel=False):
    """2D PCG under the Galerkin multigrid V-cycle (``ops/multigrid.py``,
    smoother ``line_rz``): K1 (5 planes) on the ``kernel_levels`` finest
    levels, the 9-point apply below; Chebyshev of ``degree`` before and after
    the coarse correction, ``coarse_degree`` on the coarsest level; the line
    solves through K3 with ``pcr_kernel``. Setup:
    assembly, load, per level the inverse diagonal, both line factorizations,
    the half planes (the CG matvec's again), the power iterations and the
    Galerkin product."""
    f = itemsize
    levels = []
    for l in range(n_levels):
        nzl, nrl = (nz - 1) // 2**l + 1, (nr - 1) // 2**l + 1
        n = nzl * nrl
        levels.append(dict(p=B * n * f, v=S * B * n * f, m=B * n,
                           nz=nzl, nr=nrl,
                           kz=_n_steps(nzl, line_steps), kr=_n_steps(nrl, line_steps),
                           planes=5 if l < kernel_levels else 9))

    def line_rz(L, vec, plane):
        return (_pcr_apply(L["kr"], vec, plane, L["nr"], pcr_kernel)
                + _pcr_apply(L["kz"], vec, plane, L["nz"], pcr_kernel) + 3 * vec)

    def apply_(L):
        return L["planes"] * L["p"] + 2 * L["v"]

    def chebyshev(L, deg):
        if deg <= 0:
            return 0
        step = apply_(L) + 3 * L["v"] + L["m"] + line_rz(L, L["v"], L["p"])
        return deg * step + 5 * L["v"] + (deg - 1) * 6 * L["v"]

    def v_cycle(l):
        L = levels[l]
        if l == n_levels - 1:
            return chebyshev(L, coarse_degree)
        coarse = levels[l + 1]["v"]
        return (chebyshev(L, degree) + apply_(L) + 3 * L["v"] + L["m"]  # residual
                + (L["v"] + coarse) + v_cycle(l + 1) + (coarse + L["v"])  # restrict, prolong
                + 3 * L["v"] + L["m"] + chebyshev(L, degree))

    setup = _load_2d(B, S, nz, nr, f)
    for l, L in enumerate(levels):
        p = L["p"]
        setup += 2 * p + _pcr_factor(L["kr"], p) + _pcr_factor(L["kz"], p)
        if l < kernel_levels:
            setup += 14 * p  # half planes: 9 read, 5 written
        setup += power_iters * (11 * p + line_rz(L, p, p) + 4 * p)
        if l < n_levels - 1:
            q = levels[l + 1]
            # 9 comb probes: prolong, apply, restrict, gather, Dirichlet.
            setup += 9 * (q["p"] + p) + 27 * p + 9 * (p + q["p"]) + 18 * q["p"] + (
                18 * q["p"] + q["m"])
    setup += 14 * levels[0]["p"] if kernel_levels else 0  # the CG matvec's half planes
    return setup + _cg(iterations, levels[0]["v"], apply_(levels[0]), v_cycle(0))


def direct_factor_bytes_2d(B, nz, nr, itemsize=4, schedule="bcr"):
    """The 2D direct factor's stored blocks: NZ Schur inverses ("scan", "fp")
    or cyclic reduction's levels ("bcr"), NR x NR each."""
    blocks = _blocks_bcr(nz) if schedule == "bcr" else nz
    return B * blocks * nr * nr * itemsize


def traffic_direct_2d(B, S, nz, nr, iterations, *, itemsize=4, schedule="bcr", use_kernel=True):
    """2D PCG under the block-direct preconditioner (``ops/block_direct.py``,
    ``ops/block_bcr.py``): the factor G is written once and read twice per
    apply (down and up; cyclic reduction's root block once); the chain's
    apply also reads the 3 coupling diagonals and their transposes. The CG
    matvec is K1 (5 planes)."""
    f = itemsize
    n = nz * nr
    p, v = B * n * f, S * B * n * f
    G = direct_factor_bytes_2d(B, nz, nr, f, schedule)
    if schedule == "bcr":
        apply_ = 2 * G - B * nr * nr * f + 2 * v
    else:
        apply_ = 2 * G + 2 * v + 6 * p
    matvec = (5 if use_kernel else 9) * p + 2 * v
    setup = _load_2d(B, S, nz, nr, f) + 9 * p + G + (14 * p if use_kernel else 0)
    return setup + _cg(iterations, v, matvec, apply_)


def _load_3d(B, S, nz, np_, nr, f, use_kernel):
    """Assembly, Dirichlet elimination, the half planes of both stencils and
    the singularity-subtracted load with its lift (raw stencil, no pole tie)
    and its pole tie."""
    n = nz * np_ * nr
    p, v, m = B * n * f, S * B * n * f, B * n
    cells = B * (nz - 1) * (np_ - 1) * (nr - 1) * f
    assembly = 3 * p + cells + 27 * p
    dirichlet = 27 * p + m + 27 * p
    halves = 2 * 28 * p if use_kernel else 0  # 14 planes read, 14 written, per stencil
    lift = (14 if use_kernel else 27) * p + 2 * v
    load = (3 * p + v) + (3 * p + cells + v) + (v + m + v) + lift + 3 * v + (2 * v + m) + 2 * v
    return assembly + dirichlet + halves + load


def _matvec_3d(p, v, use_kernel):
    """The pole-tied operator: K2 with the tie fused (14 planes), or the
    27-plane apply between two pole projections (a copy each)."""
    return 14 * p + 2 * v if use_kernel else 27 * p + 2 * v + 4 * v


def traffic_adi_3d(B, S, nz, np_, nr, iterations, *, itemsize=4, use_kernel=True,
                   pcr_kernel=False):
    """3D pole-tied PCG under the damped z-p-r-p-z ADI sweep
    (``parallel/runtime._pcg3``): per apply a pole tie of r, the z line solve,
    then for p, r, p, z a residual (the operator and r - Az), the line solve,
    a pole tie and the update; each pole tie copies the vector (2V); the line
    solves through K3 with ``pcr_kernel``. Setup: assembly, load, the z, p, r
    line factorizations."""
    f = itemsize
    n = nz * np_ * nr
    p, v = B * n * f, S * B * n * f
    lengths = {"z": nz, "p": np_, "r": nr}
    k = {d: _n_steps(m, None) for d, m in lengths.items()}
    matvec = _matvec_3d(p, v, use_kernel)
    pole = 2 * v
    sweep = pole + _pcr_apply(k["z"], v, p, nz, pcr_kernel) + pole + 2 * v
    for d in ("p", "r", "p", "z"):
        sweep += matvec + 3 * v + _pcr_apply(k[d], v, p, lengths[d], pcr_kernel) + pole + 3 * v
    setup = _load_3d(B, S, nz, np_, nr, f, use_kernel) + sum(_pcr_factor(k[d], p) for d in k)
    return setup + _cg(iterations, v, matvec, sweep)


def direct_factor_bytes_3d(B, nz, np_, nr, itemsize=4, schedule="bcr"):
    """The 3D direct factor's stored arrays: NZ Schur inverses of (NP*NR)^2
    ("scan", "fp"), or cyclic reduction's level 0 (the odd planes' inverses
    and the 9 banded coupling planes of each half) and its dense levels
    ("bcr", ``ops/block_bcr3d.py``)."""
    npr = np_ * nr
    block = npr * npr * itemsize
    if schedule != "bcr":
        return B * nz * block
    couplings = 9 * (nz - 1) * npr * itemsize
    return B * ((nz // 2) * block + couplings + _blocks_bcr((nz + 1) // 2) * block)


def traffic_direct_3d(B, S, nz, np_, nr, iterations, *, itemsize=4, schedule="bcr",
                      use_kernel=True):
    """3D pole-tied PCG under the banded-block direct preconditioner: the
    factor written once and read twice per apply (cyclic reduction's root
    block once), two pole ties around it; the chain's apply also reads the 9
    coupling planes per sweep."""
    f = itemsize
    n = nz * np_ * nr
    p, v = B * n * f, S * B * n * f
    G = direct_factor_bytes_3d(B, nz, np_, nr, f, schedule)
    if schedule == "bcr":
        apply_ = 2 * G - B * (np_ * nr) ** 2 * f + 2 * v + 2 * (2 * v)
    else:
        apply_ = 2 * G + 2 * v + 18 * p + 2 * (2 * v)
    setup = _load_3d(B, S, nz, np_, nr, f, use_kernel) + 27 * p + G
    return setup + _cg(iterations, v, _matvec_3d(p, v, use_kernel), apply_)


def solve_traffic_bytes(config, report, is_3d: bool) -> int | None:
    """The least bytes of a log's solve phase, summed over its chunks, for the
    route the executor took (``config``: its resolved ``ExecutorConfig``;
    ``report``: its ``last_report``). None for a route without a model here
    ("local", "lines", a multigrid with another smoother)."""
    B, S = report.get("chunk"), report.get("n_solve_slots")
    if not report["chunks"] or B is None:
        return None
    f = np.dtype(config.dtype).itemsize
    kernel = config.use_stencil_kernel
    pcr = torch.device(config.device).type == "cuda" and lines.PCR_KERNEL  # K3 runs
    if is_3d:
        dims = (config.spec3d.nz, config.spec3d.np_, config.spec3d.nr)
        if config.precond3d == "adi":
            def one(it):
                return traffic_adi_3d(B, S, *dims, it, itemsize=f, use_kernel=kernel,
                                      pcr_kernel=pcr)
        elif config.precond3d == "direct":
            def one(it):
                return traffic_direct_3d(B, S, *dims, it, itemsize=f,
                                         schedule=config.direct_schedule, use_kernel=kernel)
        else:
            return None
    else:
        nz, nr = config.spec.nz, config.spec.nr
        n_levels = _feasible_mg_levels(nz, nr)
        if config.preconditioner == "multigrid" and n_levels > 1 and (
                config.mg_smoother == "line_rz"):
            def one(it):
                return traffic_multigrid_2d(
                    B, S, nz, nr, it, itemsize=f, n_levels=n_levels, degree=config.mg_degree,
                    power_iters=config.mg_power_iters, kernel_levels=2 if kernel else 0,
                    line_steps=config.mg_line_steps, pcr_kernel=pcr)
        elif config.preconditioner == "direct":
            def one(it):
                return traffic_direct_2d(B, S, nz, nr, it, itemsize=f,
                                         schedule=config.direct_schedule, use_kernel=kernel)
        else:
            return None
    return sum(one(c["iterations"]) for c in report["chunks"])


# ----------------------------------------------------------------------------------
# One workload, in a child process
# ----------------------------------------------------------------------------------


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _grid(text: str, n: int) -> tuple[int, ...]:
    dims = tuple(int(x) for x in text.lower().split("x"))
    if len(dims) != n:
        raise ValueError(f"grid {text!r}: give {n} sizes joined by 'x'")
    return dims


def _simulate_kwargs(name: str, args) -> dict:
    """The timed call's keyword arguments: the device, float32, the grid."""
    kw = {"device": "cpu" if args.cpu else "cuda", "dtype": "float32", "verbose": False}
    if name == "3d" and args.grid_3d:
        nz, np_, nr = _grid(args.grid_3d, 3)
        kw["grid_spec3d"] = GridSpec3D(nz=nz, np_=np_, nr=nr, n_wall_cells=3, n_blend_cells=2)
    if name == "2d" and args.grid_2d:
        nz, nr = _grid(args.grid_2d, 2)
        kw["grid_spec"] = GridSpec2D(nz=nz, nr=nr, n_wall_cells=4, n_blend_cells=2)
    return kw


def _tables(name: str, args):
    if name == "3d":
        return model_tables(args.formation_3d, args.borehole_3d, BM3_FORMATION, BM3_BOREHOLE,
                            "BM3")
    return model_tables(args.formation_2d, args.borehole_2d, BM2_FORMATION, BM2_BOREHOLE,
                        "BM2-like")


def _busy_and_top(prof, wall_s: float):
    """Of a profile: the union of the device activities' intervals (kernels
    and copies; the device-side span of an annotation range such as
    ``remo3d_tpu_torch.solve_chunk``, where one was recorded, left out) over
    the wall, the TOP_KERNELS activities with the most device time (name, ms)
    and the number of activities. Reads the profiler's raw events: building
    its event tree (``prof.events()``) takes minutes for the hundreds of
    thousands of activities of a log."""
    events = prof.profiler.kineto_results.events()
    ranges = {e.name() for e in events if e.is_user_annotation()}
    spans = []
    by_name = collections.defaultdict(float)
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.name() in ranges:
            continue
        start, length = e.start_ns(), e.duration_ns()
        spans.append((start, start + length))
        by_name[e.name()[:KERNEL_NAME_CHARS]] += length / 1e6
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return busy / 1e9 / wall_s, [{"name": k, "ms": ms} for k, ms in top], len(spans)


def run_workload(name: str, args) -> dict:
    """One workload: warm-up, the timed calls, the layers run, the spot
    check. Returns its numbers and ``failures`` (the checks that failed)."""
    on_cuda = not args.cpu
    if on_cuda and not torch.cuda.is_available():
        raise SystemExit("remo3d_tpu_torch.bench: no CUDA card is visible (--cpu is for tests)")
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    is_3d = name == "3d"
    tools = TOOLS_3D if is_3d else EXAMPLE01_TOOLS
    depths = DEPTHS_3D if is_3d else DEPTHS_2D
    if args.n_depths:
        depths = depths[: args.n_depths]
    formation, borehole = _tables(name, args)
    sim = _simulate_kwargs(name, args)
    model = Model(tools)
    model.set_model_parameters(formation, borehole, borehole_geometry_type="radius",
                               dip=DIP_3D if is_3d else 0)
    model.initialize_workers(cpu_workers=4)
    failures = []

    def call():
        """One log; returns its wall and what the executor left behind (read
        before the next call replaces the executor)."""
        sync()
        t0 = time.perf_counter()
        model.simulate_logs(depths, **sim)
        sync()
        wall = time.perf_counter() - t0
        report, config = model.last_report, model._executor.config
        vals = np.stack([model.logs[t][:, 1] for t in tools], axis=1)
        return {"wall": wall, "report": report, "config": config, "vals": vals,
                "traffic": solve_traffic_bytes(config, report, is_3d)}

    def check(run, label):
        rep, cfg = run["report"], run["config"]
        n_nan = int(np.isnan(run["vals"]).sum())
        if n_nan:
            failures.append(f"{name} {label}: {n_nan} NaN readouts")
        if rep["n_failed_solves"]:
            failures.append(f"{name} {label}: {rep['n_failed_solves']} failed solves")
        worst = max(c["worst_residual"] for c in rep["chunks"])
        if not worst <= cfg.tol * (1 + RESIDUAL_ROUNDING):
            failures.append(f"{name} {label}: worst residual {worst:.3e} above tol {cfg.tol:g}")
        return n_nan

    warm = call()
    check(warm, "warm-up")
    _log(f"bench {name}: warm-up {warm['wall']:.3f} s")
    runs = []
    for i in range(args.repeats):
        run = call()
        run["n_nan"] = check(run, f"run {i + 1}")
        runs.append(run)
        _log(f"bench {name}: run {i + 1} {run['wall']:.3f} s, phases "
             + ", ".join(f"{k} {v:.3f}" for k, v in run["report"]["phases"].items()))

    walls = [r["wall"] for r in runs]
    wall = statistics.median(walls)
    phase_names = sorted({k for r in runs for k in r["report"]["phases"]})
    phases = {k: statistics.median(r["report"]["phases"].get(k, 0.0) for r in runs)
              for k in phase_names}
    last = runs[-1]
    n_readouts = int(last["vals"].size)
    n_solves = sum(c["solves"] for c in last["report"]["chunks"])
    bw = None
    if on_cuda and all(r["traffic"] and r["report"]["phases"].get("solve") for r in runs):
        bw = statistics.median(r["traffic"] / r["report"]["phases"]["solve"]
                               / H100_SXM_HBM_BYTES_PER_S for r in runs)

    # ---- layers: one more call, under the profiler on the card, never timed ------
    t0 = time.perf_counter()
    before = launches()
    if on_cuda:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.reset_peak_memory_stats()
        # Device activities only: recording every CPU op too slows the host
        # that feeds the card (a 3D log's wall 4.9 -> 6.4 s on an H100).
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            layered = call()
        peak = torch.cuda.max_memory_allocated()
        busy, top, n_activities = _busy_and_top(prof, layered["wall"])
    else:
        layered = call()
        peak = busy = top = n_activities = None
    counts = launches_since(before)
    check(layered, "layers run")
    layers = {
        "busy_share": busy,
        "top_kernels": top,
        "device_activities": n_activities,
        "launches": counts,
        "cg_iterations": [c["iterations"] for c in layered["report"]["chunks"]],
        "cg_graph": {"capture_s": [c["capture_seconds"] for c in layered["report"]["chunks"]],
                     "replays": [c["replays"] for c in layered["report"]["chunks"]]},
        "chunks": {"batches": [c["batches"] for c in layered["report"]["chunks"]],
                   "B": layered["report"]["chunk"], "S": layered["report"]["n_solve_slots"]},
        "route": {"preconditioner": layered["report"]["preconditioner"],
                  "direct_schedule": layered["report"]["direct_schedule"],
                  "mesher": layered["report"]["mesher"]},
        "peak_memory_bytes": peak,
        "profiled_wall_s": layered["wall"] if on_cuda else None,
        "split": {k: v / wall for k, v in phases.items()},
    }
    kernel = "stencil3d_half" if is_3d else "stencil2d_half"
    if on_cuda and counts[kernel] == 0:
        failures.append(f"{name}: {kernel} was not launched")
    _log(f"bench {name}: layers ({time.perf_counter() - t0:.1f} s) {json.dumps(layers)}")

    # ---- spot check: float32 (the timed route) against float64 (direct) -------------
    t0 = time.perf_counter()
    n = len(depths)
    sub = depths[sorted({n // 5, n // 2, (4 * n) // 5})]
    f32 = _spot_log(model, sub, tools, sim)
    direct = ({"executor_overrides": {"precond3d": "direct"}} if is_3d
              else {"preconditioner": "direct"})
    f64 = _spot_log(model, sub, tools, {**sim, "dtype": "float64", "tol": SPOT_TOL64, **direct})
    spot = float(np.max(np.abs(f32 / f64 - 1)))
    if not spot <= SPOT_REL[name]:
        failures.append(f"{name}: float32 vs float64 at depths {sub.tolist()}: {spot:.3e} > "
                        f"{SPOT_REL[name]:g}")
    _log(f"bench {name}: spot check at depths {sub.tolist()} ({time.perf_counter() - t0:.1f} "
         f"s): float32 vs float64 {spot:.3e} (limit {SPOT_REL[name]:g})")
    model.shutdown_workers()

    foreign = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "remo3d_tpu"})
    if foreign:
        failures.append(f"{name}: imported {foreign}")
    return {
        "workload": name,
        "model": "inline" if getattr(args, f"formation_{name}") is None else "file",
        "n_depths": n,
        "n_readouts": n_readouts,
        "n_solves": n_solves,
        "n_nan": max(r["n_nan"] for r in runs),
        "wall_s": wall,
        "runs_s": walls,
        "warmup_s": warm["wall"],
        "phases_s": phases,
        "traffic_bytes": last["traffic"],
        "bw_util": bw,
        "spot_rel": spot,
        "layers": layers,
        "failures": failures,
    }


def _spot_log(model, depths, tools, sim) -> np.ndarray:
    model.simulate_logs(depths, **sim)
    return np.stack([model.logs[t][:, 1] for t in tools], axis=1)


# ----------------------------------------------------------------------------------
# The parent: each workload in a child under a time limit, then the one line
# ----------------------------------------------------------------------------------

_ACTIVE_GROUPS: set[int] = set()  # process groups of the children running now


def _end_children(signum, frame):
    """SIGTERM or SIGINT to the parent: kill the children's process groups first."""
    for pgid in list(_ACTIVE_GROUPS):
        try:
            os.killpg(pgid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    os._exit(128 + signum)


def run_child(argv: list[str], limit_s: float) -> dict:
    """Run ``argv`` under ``timeout -k 10 <limit_s>`` in a process group of
    its own and wait for it; its standard output goes to this process's
    standard error, but for its last line, which is parsed as JSON. Returns
    {"status": "ok" | "cut" | "failed", "returncode", "seconds", "result"}.
    "cut" means the limit ended the child (exit 124, or 137 after the kill 10
    s later); timeout signals the child's whole process group, and a watchdog
    kills the group should timeout itself fail to."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(["timeout", "-k", "10", str(limit_s), *argv],
                            stdout=subprocess.PIPE, text=True, start_new_session=True)

    def kill_group():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    _ACTIVE_GROUPS.add(proc.pid)
    watchdog = threading.Timer(limit_s + 30, kill_group)
    watchdog.start()
    last = None
    try:
        for line in proc.stdout:
            if line.strip():
                if last is not None:
                    print(last, file=sys.stderr, flush=True)
                last = line.rstrip("\n")
        proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            kill_group()
            proc.wait()
        kill_group()  # whatever the child left running in its group
        _ACTIVE_GROUPS.discard(proc.pid)
    result = None
    try:
        result = json.loads(last) if last else None
    except json.JSONDecodeError:
        print(last, file=sys.stderr, flush=True)
    rc = proc.returncode
    status = "ok" if rc == 0 and isinstance(result, dict) else (
        "cut" if rc in (124, 137, -9) else "failed")
    return {"status": status, "returncode": rc, "seconds": time.perf_counter() - t0,
            "result": result}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _child_argv(name: str, args) -> list[str]:
    argv = [sys.executable, "-m", "remo3d_tpu_torch.bench", "--workload", name,
            "--repeats", str(args.repeats)]
    if args.cpu:
        argv.append("--cpu")
    for opt in ("grid_2d", "grid_3d", "n_depths", "formation_2d", "borehole_2d",
                "formation_3d", "borehole_3d"):
        value = getattr(args, opt)
        if value is not None:
            argv += ["--" + opt.replace("_", "-"), str(value)]
    return argv


def assemble(results: dict, failures: list[str], device: str) -> dict:
    """The one line from the workloads' results (None for a workload that
    gave none)."""
    w3, w2 = results.get("3d"), results.get("2d")
    out = {"metric": None, "value": None, "unit": "points/s", "vs_baseline": None}
    if w3:
        pts3 = w3["n_depths"] / w3["wall_s"]
        out.update({
            "metric": f"3D dipping-log points/sec (BM3 dip={DIP_3D}, {w3['n_depths']} pts, "
                      f"{len(TOOLS_3D)} tool)",
            "value": pts3,
            "vs_baseline": pts3 / REFERENCE_3D_POINTS_PER_S,
        })
    out.update({
        "elapsed_3d_s": w3 and w3["wall_s"],
        "n_nan_3d": w3 and w3["n_nan"],
        "phases_3d_s": w3 and w3["phases_s"],
        "pts2d_per_s": w2 and w2["n_readouts"] / w2["wall_s"],
        "solves2d_per_s": w2 and w2["n_solves"] / w2["wall_s"],
        "vs_baseline_2d_readouts": w2 and w2["n_readouts"] / w2["wall_s"]
        / REFERENCE_2D_POINTS_PER_S,
        "elapsed_2d_s": w2 and w2["wall_s"],
        "n_nan_2d": w2 and w2["n_nan"],
        "phases_2d_s": w2 and w2["phases_s"],
        "bw_util_3d": w3 and w3["bw_util"],
        "bw_util_2d": w2 and w2["bw_util"],
    })
    for name, w in (("3d", w3), ("2d", w2)):
        out[f"runs_{name}_s"] = w and w["runs_s"]
        out[f"warmup_{name}_s"] = w and w["warmup_s"]
        out[f"traffic_{name}_bytes"] = w and w["traffic_bytes"]
        out[f"spot_{name}_rel"] = w and w["spot_rel"]
    out["layers"] = {name: w and w["layers"] for name, w in (("3d", w3), ("2d", w2))}
    out["model"] = {name: w and w["model"] for name, w in (("3d", w3), ("2d", w2))}
    out["device"] = device
    out["ok"] = not failures
    out["failures"] = failures
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5, help="timed calls per workload (default 5)")
    ap.add_argument("--limit", type=float, default=600.0,
                    help="seconds per workload's child (default 600)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (tests only)")
    ap.add_argument("--grid-2d", default=None, help="2D grid NZxNR (default 761x161)")
    ap.add_argument("--grid-3d", default=None, help="3D grid NZxNPxNR (default 193x17x49)")
    ap.add_argument("--n-depths", type=int, default=None,
                    help="only the first N depths of each log (default: all)")
    for dim in ("2d", "3d"):
        ap.add_argument(f"--formation-{dim}", default=None, help=f"{dim} formation model file")
        ap.add_argument(f"--borehole-{dim}", default=None, help=f"{dim} borehole model file")
    ap.add_argument("--workload", choices=WORKLOADS, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.workload:
        print(json.dumps(run_workload(args.workload, args)), flush=True)
        return 0
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("remo3d_tpu_torch.bench: no CUDA card is visible; the bench runs "
                         "on the card (--cpu is for the tests)")
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _end_children)
    device = "cpu" if args.cpu else card_line()
    results, failures, seconds = {}, [], {}
    for name in WORKLOADS:
        run = run_child(_child_argv(name, args), args.limit)
        seconds[name] = run["seconds"]
        if run["status"] == "cut":
            failures.append(f"{name}: cut at the limit of {args.limit:g} s "
                            f"(exit {run['returncode']})")
        elif run["status"] != "ok":
            failures.append(f"{name}: the workload failed (exit {run['returncode']})")
        else:
            results[name] = run["result"]
            failures += run["result"]["failures"]
    line = assemble(results, failures, device)
    line["workload_s"] = seconds
    print(json.dumps(line), flush=True)
    return 0 if line["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
