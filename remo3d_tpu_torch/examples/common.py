# -*- coding: utf-8 -*-
"""What the examples share: the command line, the kernels' launch counts, the
results files read back, and the Levenberg-Marquardt loop of the inversions."""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def arguments(description: str, files: bool = True, output: bool = True):
    """The examples' options: ``--cpu``, ``--formation FILE --borehole FILE``
    (the reference's TSV files; else the inline model) and ``--output DIR``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: cuda)")
    if files:
        ap.add_argument("--formation", default=None, help="formation model file")
        ap.add_argument("--borehole", default=None, help="borehole model file")
    if output:
        ap.add_argument("--output", default="./Output", help="results folder")
    args = ap.parse_args()
    args.device = "cpu" if args.cpu else "cuda"
    return args


def launches() -> dict:
    """The kernels' launch counts so far (K1 ``stencil2d_half``, K2
    ``stencil3d_half``, K3 ``pcr_lines``)."""
    from ..kernels import pcr_lines, stencil2d, stencil3d

    return {"stencil2d_half": stencil2d.LAUNCHES, "stencil3d_half": stencil3d.LAUNCHES,
            "pcr_lines": pcr_lines.LAUNCHES}


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items()}


def read_back(folder: str, logs: dict) -> float:
    """Read every Results_N.txt in ``folder`` and hold it against ``logs``
    (tool name -> (n, 2) [depth, Ra]); returns the largest difference. The
    files hold 4 decimals, so a difference above 5e-5 (plus float64 rounding)
    raises, as does a tool missing from the files."""
    seen, worst = set(), 0.0
    for path in sorted(glob.glob(os.path.join(folder, "Results_*.txt"))):
        with open(path) as f:
            names = f.readline().rstrip("\n").split("\t")
        table = np.atleast_2d(np.loadtxt(path, skiprows=2, delimiter="\t"))
        for col, name in enumerate(names[1:], start=1):
            log = np.asarray(logs[name], dtype=float)
            for ref, got in ((log[:, 0], table[:, 0]), (log[:, 1], table[:, col])):
                if ref.shape != got.shape or not np.array_equal(np.isnan(ref), np.isnan(got)):
                    raise AssertionError(f"{path}: {name} does not match the log")
                diff = float(np.nanmax(np.abs(ref - got), initial=0.0))
                if diff > 5e-5 + 1e-9 * float(np.nanmax(np.abs(ref), initial=0.0)):
                    raise AssertionError(f"{path}: {name} differs from the log by {diff:g}")
                worst = max(worst, diff)
            seen.add(name)
    if seen != set(logs):
        raise AssertionError(f"results files in {folder} hold {sorted(seen)}, not {sorted(logs)}")
    return worst


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def levenberg_marquardt(dlog, start: float, n_iter: int):
    """Invert ``dlog``'s own log at ``dlog.params0`` from a uniform ``start``
    ohm-m model: Levenberg-Marquardt in log-resistivity space (positivity, no
    scale), with the exact Jacobian of ``dlog.jacobian``.

    Returns (the recovered resistivities, one dict per iteration with its
    "misfit" (rms log-misfit) and "params" (the resistivities it was taken
    at)). Stops once the misfit is below 1e-4. ``dlog`` is any object with
    ``params0``, ``forward`` and ``jacobian`` (torch or numpy results).
    """
    p_true = np.asarray(dlog.params0, dtype=np.float64)
    obs = _numpy(dlog.forward(p_true))
    mask = np.isfinite(obs)
    x = np.log(np.full_like(p_true, start))
    lam = 1e-2
    misfit_prev = np.inf
    history = []
    for it in range(n_iter):
        p = np.exp(x)
        sim = np.nan_to_num(_numpy(dlog.forward(p)))
        J = np.nan_to_num(_numpy(dlog.jacobian(p)))  # (n_meas, n_tools, P)
        # Residuals and Jacobian in log-data space: d log(sim)/d log(p) = J * p / sim.
        r = (np.log(sim[mask]) - np.log(obs[mask])).astype(np.float64)
        A = (J * p[None, None, :])[mask] / sim[mask][:, None]
        misfit = float(np.sqrt(np.mean(r**2)))
        history.append({"misfit": misfit, "params": p})
        print(f"iter {it:2d}  rms log-misfit {misfit:.5f}  "
              f"max param err {np.abs(p / p_true - 1).max() * 100:6.2f}%", flush=True)
        if misfit < 1e-4:
            break
        lam = max(lam * (0.3 if misfit < misfit_prev else 10.0), 1e-6)
        misfit_prev = misfit
        H = A.T @ A + lam * np.eye(A.shape[1])
        x = x - np.linalg.solve(H, A.T @ r)
    return np.exp(x), history


def report_inversion(dlog, p_final) -> float:
    """Print the recovered table; returns the worst relative error."""
    p_true = np.asarray(dlog.params0, dtype=np.float64)
    print("\n  parameter     true   recovered   error")
    for name, pt, pf in zip(dlog.param_names, p_true, p_final):
        print(f"  {name:9s} {pt:8.2f}   {pf:8.2f}   {abs(pf / pt - 1) * 100:5.2f}%")
    worst = float(np.abs(p_final / p_true - 1).max())
    print(f"\nworst parameter error: {worst * 100:.2f}%", flush=True)
    return worst
