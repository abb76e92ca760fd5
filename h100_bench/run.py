# -*- coding: utf-8 -*-
"""Run one cell of the benchmark of ``remo3d_tpu_torch`` once, on the card.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; everything else is found by name:

* ``h100_bench/configs/<config>.json``: the deployment (tables, tools, depths,
  dip, grid, type, tolerance);
* ``h100_bench/traffic/<traffic>.json``: the mix (entry kind, its parameters),
  which :mod:`h100_bench.drive` turns into requests;
* ``h100_bench/limits/<cell>.json``: the limit of each number the check
  compares;
* ``h100_bench/end_to_end/<metric>.py`` and ``h100_bench/layers/<metric>.py``:
  one reader per metric, the file named by the metric's name, ``read(ctx)``
  returning its value or None (then the metric is left out of the line).

A run: set-up (imports, the CUDA context, the kernel and mesher libraries,
the entry's objects and one warm request of the cell's shapes: ``setup_s``,
from the process's start); the window, a closed loop that submits request
i + 1 when request i has returned, from the first submission to the last
completion, at least ``--seconds`` long; with ``--trace 1`` requests 1 to
``trace_requests`` of the window under torch.profiler (device activities);
then, with the program's state freed, the check against the plain reference
on a sample of the window's answers drawn from the seed. The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit); the last lines of
standard error give the same numbers. Without a card, or with fewer cards
than the cell asks for, it exits 1 and prints no result; so it does if the
process holds JAX or the JAX package once the window has closed.

A traffic with ``"ranks": N`` runs the cell over N processes, one card
each, this one rank 0 (:mod:`h100_bench.ranks`).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# Top-level module names that no run may hold: JAX, its libraries, the JAX
# package, and the JAX-era benchmarks.
FOREIGN = ("jax", "jaxlib", "flax", "remo3d_tpu", "bench", "benchmarks")
FOREIGN_MODULES = ("remo3d_tpu_torch.bench",)
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(kind: str, name: str):
    """The ``read`` function of metric ``name`` (``<kind>/<name>.py``)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"h100_bench_{kind}_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_spec(bench: dict, name: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metrics."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"h100_bench: no cell {name!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]
    return {
        "cell": cell,
        "config": load_json(os.path.join(os.path.dirname(HERE), config_entry["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
        "limits": load_json(os.path.join(HERE, "limits", name + ".json")),
        "end_to_end": end_to_end,
        "per_layer": per_layer,
    }


def foreign_modules() -> list:
    tops = {m.split(".")[0] for m in sys.modules}
    return sorted((tops & set(FOREIGN)) | (set(sys.modules) & set(FOREIGN_MODULES)))


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None) -> dict:
    """One run of a cell; returns the result line's object. ``device`` "cpu"
    is for the tests: they drive a run at a small size without a card."""
    import torch

    from . import drive
    from . import trace as tracing

    on_cuda = device.startswith("cuda")
    cell, traffic = spec["cell"], spec["traffic"]
    w = drive.Workload(spec["config"], traffic, seed)
    entry = drive.ENTRIES[traffic["entry"]](w, device)
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)

    def one(i: int) -> dict:
        t0 = time.perf_counter()
        try:
            rec = entry.request(i)
        except Exception:  # the run goes on; the request counts as failed
            log(f"h100_bench: request {i} raised:\n{traceback.format_exc()}")
            rec = {"failed": True, "work": 0}
        rec["wall"] = time.perf_counter() - t0
        return rec

    warm = one(-1)
    if warm["failed"]:
        log("h100_bench: the warm request failed")
    sync()
    setup_s = time.perf_counter() - (T_START if t_start is None else t_start)
    log(f"h100_bench: {cell['name']} seed {seed}: set-up {setup_s:.3f} s")

    n_trace = int(traffic.get("trace_requests", 2)) if trace else 0
    records, stretch = [], None
    t0 = time.perf_counter()
    while len(records) < 1 + n_trace or time.perf_counter() - t0 < seconds:
        if trace and len(records) == 1:
            with tracing.profiler(on_cuda) as prof:
                h0 = time.perf_counter()
                for _ in range(n_trace):
                    records.append(one(len(records)))
                sync()
                host_s = time.perf_counter() - h0
            stretch = tracing.read(prof, host_s)
            log(f"h100_bench: traced stretch: requests 1-{n_trace} of the window, "
                f"{host_s:.3f} s, {len(stretch.activities)} device activities")
            continue
        records.append(one(len(records)))
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    attempted = len(records)
    failed = sum(bool(r["failed"]) for r in records)
    walls = [r["wall"] for r in records]
    log(f"h100_bench: window {window_s:.3f} s, {attempted} requests ({failed} failed), walls "
        + " ".join(f"{x:.3f}" for x in walls))

    ctx = {"records": records, "traced": records[1:1 + n_trace], "stretch": stretch,
           "window_s": window_s, "setup_s": setup_s, "workload": w}
    out = {"correct": False, "attempted": attempted, "failed": failed,
           "metrics": measure(spec, ctx, trace),
           "device": {"platform": "gpu", "kind": torch.cuda.get_device_name() if on_cuda
                      else "cpu", "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}}
    if stretch is not None:
        out["device"].update(busy_s=stretch.busy_s(), window_s=stretch.host_s)
        out["breakdown"] = {"device_ops": stretch.top_ops(), "idle_gaps": stretch.idle_gaps()}

    # ---- the check, with the program's state freed ---------------------------------
    entry.release()
    del stretch, ctx
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    numbers = drive.check(entry, records, device)
    log(f"h100_bench: check ({time.perf_counter() - t1:.1f} s)")
    return judge(out, spec, numbers)


def measure(spec: dict, ctx: dict, trace: bool) -> dict:
    """The line's metrics: the cell's end-to-end ones, or with ``trace`` its
    per-layer ones, each read by its own reader from ``ctx``."""
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = reader("layers" if trace else "end_to_end", m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def judge(out: dict, spec: dict, numbers: dict) -> dict:
    """``out`` with its ``correct`` and, last, its ``checks``: each number
    compared beside its limit. A number that could not be worked out (a NaN
    answer, a request that raised) is null in the line and fails the run, as
    does a limit with no number."""
    checks = {k: {"value": v if math.isfinite(v) else None, "limit": spec["limits"][k]}
              for k, v in sorted(numbers.items())}
    checks.update({k: {"value": None, "limit": v} for k, v in sorted(spec["limits"].items())
                   if k not in checks})
    out["correct"] = bool(out["attempted"] and not out["failed"]
                          and set(numbers) == set(spec["limits"])
                          and all(c["value"] is not None and c["value"] <= c["limit"]
                                  for c in checks.values()))
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="the cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the window's length")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(load_json("BENCHMARK.json"), args.workload)
    # One process with few threads: the host's thread pools (torch's
    # intra-op pool, numpy's BLAS) spin beside the threads that feed the card
    # and add to the spread of its walls. Set before torch and numpy load.
    for var in THREAD_VARS:
        os.environ.setdefault(var, "1")

    import torch

    from . import ranks

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"h100_bench: the cell needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 1
    if ranks.ranks_of(spec) > 1:
        out = ranks.run(spec, args.seed, args.seconds, bool(args.trace))
        if out is None:
            return 1
    else:
        out = run(spec, args.seed, args.seconds, bool(args.trace))
    foreign = foreign_modules()
    if foreign:
        log(f"h100_bench: the run holds {foreign}")
        return 1
    log(f"h100_bench: correct {out['correct']}, attempted {out['attempted']}, "
        f"failed {out['failed']}")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
