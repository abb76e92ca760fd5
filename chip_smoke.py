#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke test of the PyTorch port (remo3d_tpu_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, nvcc and the checkout's own sources, imports nothing of JAX, and fails
(non-zero exit, no result line) when any of them is missing or any phase fails:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: nvcc builds the kernel library from ``remo3d_tpu_torch/csrc``;
3. kernel K1 (``stencil2d_half``) against its plain torch version on the card,
   float32 and float64, at the 2D path's two multigrid shapes and an edge case,
   then both timed with CUDA events beside the bound and a CSR sparse product;
4. the 2D main path at full width: ``Model.compute_synthetic_logs`` on
   ``cuda``, 6 tools x 101 depths on the default 761x161 grid, with the kernels'
   launch counts read around the run; then the same log with the kernels off;
5. 2D cross-check: 3 depths on the card and on the CPU (plain versions) agree;
6. 2D physics: in a uniform medium every tool reads the true resistivity;
7. kernel K2 (``stencil3d_half``) against its plain version, float32 and
   float64, at the 3D path's chunk shape, the ``high_dip`` grid and an edge
   case, then timed like K1;
8. the 3D main path at full width: the 100-point Benchmark-model-3 log at dip
   30 on the default 193x17x49 grid, with the launch counts read around it;
9. the first 20 depths of that log again with the kernels off;
10. 3D cross-check in float64: 3 depths on the card and on the CPU agree;
11. 3D physics: a uniform medium at dip 30 reads the true resistivity.

The line before the last is a JSON object with one entry per kernel; the last
is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile3d`` instead builds the kernels and profiles
one warm phase-8 log with torch.profiler: kernel time by part and the device
busy share (the union of kernel intervals over the wall).
"""

from __future__ import annotations

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

EXAMPLE01_TOOLS = ["B5.7A0.4M", "B4.48A1.62M", "M1.0A0.1B", "A2.0M0.5N", "N0.5M2.0A", "M4.0A0.5B"]
# BM2-like invaded formation: TOP, BOTTOM, FZ_RADIUS, FZ_VALUE, UZ_VALUE (m, ohm-m).
FORMATION = np.array(
    [
        [-100.0, 5.0, np.nan, np.nan, 10.0],
        [5.0, 15.0, 0.2, 5.0, 100.0],
        [15.0, 25.0, np.nan, np.nan, 10.0],
        [25.0, 35.0, 0.35, 5.0, 100.0],
        [35.0, 45.0, np.nan, np.nan, 10.0],
        [45.0, 55.0, 0.5, 5.0, 100.0],
        [55.0, 200.0, np.nan, np.nan, 10.0],
    ]
)
BOREHOLE = np.array([[-100.0, 0.1, 1.0], [200.0, 0.1, 1.0]])
DEPTHS = np.arange(0.0, 10.01, 0.1)
KERNEL_SHAPES = [(96, 5, 761, 161), (96, 5, 381, 81), (1, 2, 7, 5)]
# Benchmark model 3 (benchmarks/bm3_oracle.py): 10 | 100 | 10 ohm-m, beds
# crossing the borehole axis at 10.77 and 14.23 m; 0.1 m borehole, 1 ohm-m mud.
BM3_FORMATION = np.array(
    [
        [-100.0, 10.77, np.nan, np.nan, 10.0],
        [10.77, 14.23, np.nan, np.nan, 100.0],
        [14.23, 200.0, np.nan, np.nan, 10.0],
    ]
)
BM3_BOREHOLE = np.array([[-100.0, 0.1, 1.0], [200.0, 0.1, 1.0]])
TOOLS_3D = ["A2.0M0.5N"]
DEPTHS_3D = np.arange(5.0, 29.76, 0.25)  # 100 measurement points
DIP = 30
KERNEL3D_SHAPES = [(8, 5, 193, 17, 49), (2, 5, 257, 25, 65), (1, 2, 6, 3, 5)]
# The kernels vs their plain versions, relative to max|y|: one summation order,
# but the kernels contract multiply-adds into FMAs.
TOL_REL = {"float32": 1e-5, "float64": 1e-12}
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
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 / float64 flop/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def check_and_time(torch, label, shapes, make, plain_fn, kernel_fn, half_fn, n_half, flops_per_out):
    """Phases 3 and 7: a kernel against its plain version at every shape, f32
    and f64; at the first (main-path) shape also timed against its plain
    version and a CSR sparse product, 25 interleaved calls each.

    ``make(rng, shape)`` -> (full-storage C flattened to (B, *grid, E), the
    offsets of its E entries, full C as the half-plane builder takes it).
    Returns {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
    "library_ms"} at the main shape, float32."""
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
                k_ms, p_ms, l_ms = [], [], []
                for _ in range(25):  # interleaved: plain, kernel, library
                    p_ms.append(time_ms(torch, lambda: plain_fn(C_half, u)))
                    k_ms.append(time_ms(torch, lambda: kernel_fn(C_half, u)))
                    l_ms.append(time_ms(torch, lambda: torch.sparse.mm(A, U)))
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
                del A, U, y_l
            del C_half, u, y_k, y_p
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
        stencil2d.stencil_apply_half_2d, stencil2d.half_planes_2d, 5, 18,
    )


def check_k2(torch):
    """Phase 7: K2 against its plain version, then timed at the chunk shape."""
    from remo3d_tpu_torch.kernels import stencil3d

    def make(rng, shape):
        B, _, nz, np_, nr = shape
        C = random_symmetric_stencil_3d(rng, B, nz, np_, nr)
        offsets = [(dz, dp, dr) for dz in (-1, 0, 1) for dp in (-1, 0, 1) for dr in (-1, 0, 1)]
        return C, offsets, C

    return check_and_time(
        torch, "K2", KERNEL3D_SHAPES, make, stencil3d.stencil3d_apply_half_plain,
        stencil3d.stencil3d_apply_half, stencil3d.half_planes_3d, 14, 54,
    )


def reset_counts():
    from remo3d_tpu_torch.kernels import stencil2d, stencil3d

    stencil2d.LAUNCHES = 0
    stencil3d.LAUNCHES = 0


def read_counts():
    from remo3d_tpu_torch.kernels import stencil2d, stencil3d

    return {"stencil2d_half": stencil2d.LAUNCHES, "stencil3d_half": stencil3d.LAUNCHES}


def log_3d(torch, depths, **kwargs):
    from remo3d_tpu_torch import Model

    return Model.compute_synthetic_logs(
        TOOLS_3D, depths, BM3_FORMATION, BM3_BOREHOLE, borehole_geometry_type="radius",
        dip=DIP, verbose=False, **kwargs,
    )


def run_2d(torch, card):
    """Phases 4-6; returns the K1 launch count of the main-path run."""
    from remo3d_tpu_torch import Model
    from remo3d_tpu_torch.plotting import _write_tsv_groups

    kwargs = dict(
        borehole_geometry_type="radius", domain_radius=50, batch_size=5,
        dtype="float32", device="cuda", verbose=False,
    )
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Model.compute_synthetic_logs(EXAMPLE01_TOOLS, DEPTHS, FORMATION, BOREHOLE, **kwargs)
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
        + f"; launches {counts}"
    )
    if not np.isfinite(vals).all():
        raise AssertionError(f"{int((~np.isfinite(vals)).sum())} non-finite readouts")
    if report["n_failed_solves"] != 0:
        raise AssertionError(f"{report['n_failed_solves']} failed solves")
    if not all(0 < k < 1000 for k in iters):
        raise AssertionError(f"CG iterations {iters} (maxiter 1000)")
    if launches < 2 * sum(iters):
        raise AssertionError(f"K1 launched {launches} times for CG iterations {iters}")

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
    same_mesh = {"device_meshing": True}
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
    return launches


def run_3d(torch, card):
    """Phases 8-11; returns the K2 launch count of the main-path run."""
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
        + f"; launches {counts}"
    )
    log(f"3D log Ra (ohm-m): min {vals.min():.4f}, max {vals.max():.4f}")
    if not np.isfinite(vals).all():
        raise AssertionError(f"3D: {int((~np.isfinite(vals)).sum())} non-finite readouts")
    if report["n_failed_solves"] != 0:
        raise AssertionError(f"3D: {report['n_failed_solves']} failed solves")
    if not all(0 < k < 1000 for k in iters):
        raise AssertionError(f"3D CG iterations {iters} (maxiter 1000)")
    if launches < 5 * sum(iters):
        raise AssertionError(f"K2 launched {launches} times for CG iterations {iters}")

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
        m = log_3d(torch, sub, device=device, dtype="float64", tol=1e-10, grid_spec3d=spec)
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
    return launches


def profile_3d(torch, card):
    """One warm phase-8 log under torch.profiler: kernel time of K2, of the
    PCR line apply, of the pole projection and of the rest, and the device
    busy share (union of kernel intervals over the profiled wall)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from remo3d_tpu_torch.ops import lines3d
    from remo3d_tpu_torch.parallel import runtime

    def ranged(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    lines3d.pcr_apply = ranged("pcr_apply", lines3d.pcr_apply)
    runtime.pole_project = ranged("pole_project", runtime.pole_project)
    cuda32 = dict(device="cuda", dtype="float32")
    log_3d(torch, DEPTHS_3D, **cuda32)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = log_3d(torch, DEPTHS_3D, **cuda32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    names = ("pcr_apply", "pole_project")
    # Device activity (kernels, copies), without the GPU-side copies of the
    # two annotation ranges.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in names]
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
    busy /= 1e3
    k2 = sum(e.device_time_total for e in kernels if "stencil3d_half" in e.name) / 1e3
    ranges = {
        name: sum(e.device_time_total for e in events
                  if e.name == name and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
        for name in names
    }
    rest = total - k2 - sum(ranges.values())
    iters = [c["iterations"] for c in model.last_report["chunks"]]
    log(f"profile on {card}: 3D log wall {wall_ms:.1f} ms, CG iterations {iters}, "
        f"{len(kernels)} kernels")
    log(f"profile: kernel time {total:.1f} ms; busy (union of kernel intervals) {busy:.1f} ms = "
        f"{busy / wall_ms:.3f} of the wall")
    for name, ms in (("K2 stencil3d_half", k2), ("PCR line apply", ranges["pcr_apply"]),
                     ("pole_project", ranges["pole_project"]), ("rest", rest)):
        log(f"profile:   {name}: {ms:.1f} ms ({ms / total:.1%} of kernel time)" if total else
            f"profile:   {name}: no device time recorded")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    sys.path.insert(0, REPO)
    import remo3d_tpu_torch
    from remo3d_tpu_torch.kernels import build

    pkg_dir = os.path.dirname(os.path.abspath(remo3d_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != REPO:
        raise SystemExit(f"chip_smoke: remo3d_tpu_torch imported from {pkg_dir}, not this checkout")
    if any(m.split(".")[0] in ("jax", "remo3d_tpu") for m in sys.modules):
        raise SystemExit("chip_smoke: JAX was imported")

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 2. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    log(f"build: {build.library_path().name} in {time.perf_counter() - t0:.1f} s")

    if sys.argv[1:] == ["--profile3d"]:
        profile_3d(torch, card)
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")

    t_start = time.perf_counter()
    k1 = check_k1(torch)  # 3
    k1["launches"] = run_2d(torch, card)  # 4-6
    log(f"2D phases done at {time.perf_counter() - t_start:.1f} s")
    k2 = check_k2(torch)  # 7
    k2["launches"] = run_3d(torch, card)  # 8-11
    log(f"3D phases done at {time.perf_counter() - t_start:.1f} s")

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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
