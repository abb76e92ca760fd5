#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke test of the PyTorch port (remo3d_tpu_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, nvcc and the checkout's own sources, imports nothing of JAX, and fails
(non-zero exit, no result line) when any of them is missing or any phase fails:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: nvcc builds the kernel library from ``remo3d_tpu_torch/csrc``;
3. kernel K1 (``stencil2d_half``) against its plain torch version on the card,
   float32 and float64, at the main path's two multigrid shapes and an edge
   case, then both timed with CUDA events;
4. the main path at full width: ``Model.compute_synthetic_logs`` on ``cuda``,
   6 tools x 101 depths on the default 761x161 grid, with the kernel's launch
   count read around the run; then the same log with the kernel switched off;
5. cross-check: 3 depths on the card and on the CPU (plain versions) agree;
6. physics: in a uniform medium every tool reads the true resistivity.

The line before the last is a JSON object with one entry per kernel; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

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
# K1 vs its plain version, relative to max|y|: one summation order, but the
# kernel contracts multiply-adds into FMAs.
TOL_REL = {"float32": 1e-5, "float64": 1e-12}
# One float32 log at tol 3e-7 sits within 2.2e-4 of its float64 solve (README,
# "Solver arithmetic"). The CPU cross-check is held to 2e-4; two float32 runs
# on the card that differ only in summation order to twice the 2.2e-4.
LOG_REL = 2e-4
LOG_REL_PAIR = 4.4e-4


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Device time (ms) of one call of ``fn``, with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def check_kernel(torch, dev):
    """Phase 3: K1 against its plain version, then timed at the main shapes."""
    from remo3d_tpu_torch.kernels import stencil2d

    rng = np.random.default_rng(2024)
    worst = {}
    timings = {}
    for shape in KERNEL_SHAPES:
        B, S, nz, nr = shape
        C64 = random_symmetric_stencil_2d(rng, B, nz, nr)
        u64 = rng.standard_normal(shape)
        for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            C = torch.as_tensor(C64, device=dev).to(dt)
            C_half = stencil2d.half_planes_2d(C)
            u = torch.as_tensor(u64, device=dev).to(dt)
            y_k = stencil2d.stencil_apply_half_2d(C_half, u)
            y_p = stencil2d.stencil_apply_half_2d_plain(C_half, u)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            rel = err / float(y_p.abs().max())
            log(
                f"K1 {name} {shape}: max|kernel-plain| = {err:.3e}, relative to max|y| "
                f"{rel:.3e} (tolerance {TOL_REL[name]:g})"
            )
            if not rel <= TOL_REL[name]:
                raise AssertionError(f"K1 {name} {shape}: rel err {rel:.3e} > {TOL_REL[name]}")
            worst[(name, shape)] = err
            if name == "float32" and shape != KERNEL_SHAPES[-1]:
                for _ in range(3):  # warm-up
                    stencil2d.stencil_apply_half_2d(C_half, u)
                    stencil2d.stencil_apply_half_2d_plain(C_half, u)
                k_ms, p_ms = [], []
                for _ in range(25):  # interleaved: plain, kernel
                    p_ms.append(time_ms(torch, lambda: stencil2d.stencil_apply_half_2d_plain(C_half, u)))
                    k_ms.append(time_ms(torch, lambda: stencil2d.stencil_apply_half_2d(C_half, u)))
                k, p = float(np.median(k_ms)), float(np.median(p_ms))
                gbps = 4.0 * nz * nr * B * (5 + 2 * S) / (k * 1e-3) / 1e9
                log(
                    f"K1 float32 {shape}: kernel {k:.4f} ms, plain {p:.4f} ms "
                    f"(median of 25; kernel moves >= {gbps:.0f} GB/s)"
                )
                timings[shape] = (k, p)
            del C, C_half, u, y_k, y_p
    return worst, timings


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    sys.path.insert(0, REPO)
    import remo3d_tpu_torch
    from remo3d_tpu_torch import Model
    from remo3d_tpu_torch.kernels import build, stencil2d
    from remo3d_tpu_torch.plotting import _write_tsv_groups

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

    # ---- 3. K1 against its plain version ---------------------------------------------
    worst, timings = check_kernel(torch, dev)

    # ---- 4. main path ----------------------------------------------------------------
    kwargs = dict(
        borehole_geometry_type="radius", domain_radius=50, batch_size=5,
        dtype="float32", device="cuda", verbose=False,
    )
    stencil2d.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Model.compute_synthetic_logs(EXAMPLE01_TOOLS, DEPTHS, FORMATION, BOREHOLE, **kwargs)
    elapsed = time.perf_counter() - t0
    launches = stencil2d.LAUNCHES
    report = model.last_report
    chunks = report["chunks"]
    iters = [c["iterations"] for c in chunks]
    n_solves = sum(c["solves"] for c in chunks)
    vals = np.stack([model.logs[t][:, 1] for t in EXAMPLE01_TOOLS], axis=1)
    log(
        f"main path on {card}: {len(DEPTHS)} depths x {len(EXAMPLE01_TOOLS)} tools, "
        f"{n_solves} solves in {len(chunks)} chunks of B={report['chunk']} "
        f"(S={report['n_solve_slots']}), CG iterations {iters}"
    )
    log(
        f"main path on {card}: {elapsed:.3f} s, {n_solves / elapsed:.2f} solves/s, "
        f"{vals.size / elapsed:.2f} readouts/s; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in report["phases"].items())
        + f"; K1 launches {launches}"
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
        f"main path on {card} with the plain 9-point apply: {plain_elapsed:.3f} s "
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
        f"cross-check at depths {sub.tolist()}: cuda vs cpu max rel diff {rel_cpu:.2e}; "
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
    log(f"uniform medium {rho} ohm-m: worst |Ra/Rt - 1| = {worst_u:.2e}")
    if not worst_u <= 5e-3:
        raise AssertionError(f"uniform medium: |Ra/Rt - 1| = {worst_u:.2e} > 5e-3")

    main_shape = KERNEL_SHAPES[0]
    k_ms, p_ms = timings[main_shape]
    log(card)
    print(json.dumps({"kernels": [{
        "name": "stencil2d_half",
        "route": "cuda",
        "source": "remo3d_tpu_torch/csrc/stencil2d.cu",
        "replaces": "remo3d_tpu/ops/pallas_stencil2d.py:69",
        "launches": launches,
        "max_abs_err": worst[("float32", main_shape)],
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
