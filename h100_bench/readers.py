# -*- coding: utf-8 -*-
"""What the metric readers share. Each metric has a file of its own under
``end_to_end/`` or ``layers/``, named by the metric's name, whose ``read(ctx)``
is one of these (a metric that exists in two cells, such as a kernel's
roofline under the 3D and the 2D log, has a name and a file per cell and the
same reader). ``ctx`` holds the window's records (one per request), the
traced requests, the traced stretch (:class:`h100_bench.trace.Stretch`, None
without ``--trace 1``), the window's and the set-up's seconds and the
workload. A reader that finds nothing to read returns None."""

from __future__ import annotations

import math

from . import roofline

K3_KERNELS = ("pcr_lines_kernel",)
K2_KERNELS = ("stencil3d_half_kernel",)
# The 2D V-cycle's schedule: the program's defaults (ExecutorConfig mg_degree,
# mg_power_iters; MGConfig coarse_degree), which the benchmark does not change.
MG_DEGREE, MG_COARSE_DEGREE, MG_POWER_ITERS = 2, 24, 6


# ---- end to end (host clock) ------------------------------------------------------


def setup_s(ctx):
    """Seconds from the process's start to the window's first submission."""
    return ctx["setup_s"]


def work_per_s(ctx):
    """The work (readouts, or steps) of every request completed in the window
    over the window's seconds, first submission to last completion."""
    return sum(r["work"] for r in ctx["records"] if not r["failed"]) / ctx["window_s"]


def wall_p95(ctx):
    """The nearest-rank 95th percentile of the wall of every request."""
    walls = sorted(r["wall"] for r in ctx["records"])
    return walls[math.ceil(0.95 * len(walls)) - 1] if walls else None


# ---- per layer ----------------------------------------------------------------------


def wall_p95_untraced(ctx):
    """:func:`wall_p95` of the requests of the window that ran outside the
    traced stretch (request 0 always does)."""
    traced = {id(r) for r in ctx["traced"]}
    return wall_p95({"records": [r for r in ctx["records"] if id(r) not in traced]})


def _phases_per_log(ctx, names):
    recs = [r for r in ctx["records"] if "phases" in r]
    if not recs:
        return None
    return sum(r["phases"].get(n, 0.0) for r in recs for n in names) / len(recs)


def mesh_s_per_log(ctx):
    """Host seconds per log that meshing cost the caller: the executor's
    "mesh" phase (on the caller's thread) and "pipeline_wait" (the caller
    waiting for the read-ahead thread), from ``Model.last_report["phases"]``,
    mean over the window's logs."""
    return _phases_per_log(ctx, ("mesh", "pipeline_wait"))


def stage_s_per_log(ctx):
    """Host seconds per log of staging on the caller's thread: the "stack"
    (numpy stacking) and "stage" (the copies to the card, and 2D device
    meshing) phases, mean over the window's logs."""
    return _phases_per_log(ctx, ("stack", "stage"))


def cg_iters_per_chunk(ctx):
    """CG iterations per chunk, mean over every chunk of the window's logs
    (``Model.last_report["chunks"]``)."""
    its = [c["iterations"] for r in ctx["records"] if "phases" in r for c in r["chunks"]]
    return sum(its) / len(its) if its else None


def _itemsize(ctx):
    return 8 if ctx["workload"].config["dtype"] == "float64" else 4


def _share(ctx, total_bytes, kernels):
    """Least bytes at the HBM rate over the named kernels' device seconds in
    the traced stretch, in %."""
    stretch = ctx["stretch"]
    seconds = stretch.seconds_of(kernels) if stretch else 0.0
    if seconds <= 0 or not total_bytes:
        return None
    return 100.0 * total_bytes / roofline.HBM_BYTES_PER_S / seconds


def k3_roofline(ctx):
    """K3's share of its roofline: the least bytes of the line applies of
    the traced logs (``roofline.k3_bytes_*``, for the CG iterations each
    chunk ran and its real batches: 3D, the z-p-r-p-z ADI sweep; 2D, the
    line_rz smoother of the V-cycle under MG_*) at 3.35 TB/s, over the device
    seconds of K3_KERNELS. The flops at 67 TFLOP/s are 7-13x smaller."""
    grid, f = ctx["workload"].spec_grid, _itemsize(ctx)
    total = 0
    for r in ctx["traced"]:
        for c in r.get("chunks", ()):
            if len(grid) == 3:
                total += roofline.k3_bytes_adi_3d(c["batches"], r["n_solve_slots"], grid,
                                                  c["iterations"], f)
            else:
                total += roofline.k3_bytes_multigrid_2d(
                    c["batches"], r["n_solve_slots"], *grid, c["iterations"], f,
                    degree=MG_DEGREE, coarse_degree=MG_COARSE_DEGREE,
                    power_iters=MG_POWER_ITERS)
    return _share(ctx, total, K3_KERNELS)


def k2_roofline(ctx):
    """K2's share of its roofline: the 3D operator applies' least bytes
    (``roofline.k2_bytes`` on each chunk's real batches, 5 applies per CG
    iteration and 5 before the loop) at 3.35 TB/s, over the device seconds of
    K2_KERNELS."""
    grid, f = ctx["workload"].spec_grid, _itemsize(ctx)
    if len(grid) != 3:
        return None
    total = sum(roofline.k2_applies_adi_3d(c["iterations"])
                * roofline.k2_bytes(c["batches"], r["n_solve_slots"], grid, f)
                for r in ctx["traced"] for c in r.get("chunks", ()))
    return _share(ctx, total, K2_KERNELS)


def device_idle(ctx):
    """The share of the traced stretch in which no activity ran on the card:
    1 - (the union of the device activities' intervals) / (the stretch's host
    seconds), in %."""
    s = ctx["stretch"]
    return 100.0 * (1.0 - s.busy_s() / s.host_s) if s and s.activities else None


def factor_s_per_step(ctx):
    """Device seconds of the block-direct factorization per step: the
    ``factor_s`` (CUDA events) of every chunk of both calls, forward and
    Jacobian (``DifferentiableLog.last_report["chunks"]``), mean over the
    window's steps."""
    recs = [r for r in ctx["records"] if "calls" in r]
    if not recs:
        return None
    return sum(c.get("factor_s", 0.0) for r in recs for call in r["calls"].values()
               for c in call) / len(recs)


def tangent_iters_per_step(ctx):
    """Iterations of the tangent PCG (``ops/linear_solve.py``
    ``solve_tangents``) per step, summed over the Jacobian call's chunks,
    mean over the window's steps."""
    recs = [r for r in ctx["records"] if "calls" in r]
    if not recs:
        return None
    return sum(c.get("tangent_iterations", 0) for r in recs
               for c in r["calls"]["jacobian"]) / len(recs)


# ---- per layer, over the ranks of a multi-process run (ctx["ranks"]) ---------------


def _over_ranks(ctx, per_rank):
    """The mean over the ranks of ``per_rank(rank)``, each rank's window
    records and traced summary (``h100_bench.ranks``), of those not None."""
    values = [v for v in (per_rank(r) for r in ctx.get("ranks") or ()) if v is not None]
    return sum(values) / len(values) if values else None


def plan_s_per_log_ranks(ctx):
    """Host seconds per log of the "plan" phase (``Model.simulate_logs``
    plans the whole log on every rank), mean over the window's logs and the
    ranks."""
    return _over_ranks(ctx, lambda r: _phases_per_log(r, ("plan",)))


def mesh_s_per_log_ranks(ctx):
    """:func:`mesh_s_per_log` ("mesh" + "pipeline_wait") of each rank, mean
    over the ranks."""
    return _over_ranks(ctx, lambda r: _phases_per_log(r, ("mesh", "pipeline_wait")))


def rank_wait_s_per_log(ctx):
    """Seconds per traced log from the end of a rank's last "readout" span to
    the end of its "log" root span (``spans.rank_wait_s_per_log``), mean
    over the ranks."""
    return _over_ranks(ctx, lambda r: (r["trace"] or {}).get("rank_wait_s"))


def device_idle_ranks(ctx):
    """:func:`device_idle` of each card over its rank's traced stretch, mean
    over the cards."""
    def idle(r):
        t = r["trace"]
        return 100.0 * (1.0 - t["busy_s"] / t["host_s"]) if t and t["n_activities"] else None

    return _over_ranks(ctx, idle)
