# -*- coding: utf-8 -*-
"""The readings that a cell's limits are set from, on the card, in one process.

    python3 -m h100_bench.calibrate --workload <cell> --first-seed <n>
        [--seeds 12] [--control-seeds 3] [--requests 1]

For each of ``--seeds`` seeds (``--first-seed``, +1, ...): ``--requests``
requests of the cell's traffic through the program, at the cell's sizes,
and the numbers the check compares, as a run's check draws them (the
program's readings: the lower end of each limit). For the first
``--control-seeds`` of them, the control: the reference computed in TF32 (the
nearest precision below the configuration's float32, which the program runs
with TF32 off), put in the program's place and compared the same way (the
upper end). Not part of a benchmark run. One JSON line per seed, then a
summary line: the largest program reading and the smallest control reading
of each number. A cell whose traffic has ``"ranks": N`` is read over N
processes, one card each, as its runs are (:mod:`h100_bench.ranks`), and its
sample is drawn among each rank's share as a run's check draws it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--requests", type=int, default=1)
    args = ap.parse_args(argv)

    from .run import cell_spec, load_json

    spec = cell_spec(load_json("BENCHMARK.json"), args.workload)
    return calibrate(spec, args.first_seed, args.seeds, args.control_seeds, args.requests,
                     "cuda")


def calibrate(spec, first_seed, n_seeds, n_control, n_requests, device) -> int:
    from . import drive, ranks

    if ranks.ranks_of(spec) > 1:
        return calibrate_ranks(spec, first_seed, n_seeds, n_control, n_requests, device)
    config, traffic = spec["config"], spec["traffic"]
    entry = drive.ENTRIES[traffic["entry"]](drive.Workload(config, traffic, first_seed), device)
    entry.request(-1)
    lines = []
    for seed in range(first_seed, first_seed + n_seeds):
        t0 = time.perf_counter()
        entry.w = drive.Workload(config, traffic, seed)
        records = [entry.request(i) for i in range(n_requests)]
        sample = entry.w.check_sample(n_requests, entry.n_batches)
        lines.append(readings(entry, records, sample, seed < first_seed + n_control, device,
                              t0))
    return summarize(spec, lines)


def calibrate_ranks(spec, first_seed, n_seeds, n_control, n_requests, device) -> int:
    """:func:`calibrate` over the cell's ranks: each seed's requests through
    every rank, the readings on rank 0 (the children wait meanwhile)."""
    from . import ranks

    n = ranks.ranks_of(spec)
    group = ranks.Group(n)
    lines = []
    try:
        group.start({"spec": spec, "seed": first_seed, "device": device})
        me = ranks.Rank(spec, first_seed, device)
        group.step({"i": -1, "trace": False, "seed": first_seed}, me, ranks.SETUP_S)
        for seed in range(first_seed, first_seed + n_seeds):
            t0 = time.perf_counter()
            records, owner_of = [], {}
            for i in range(n_requests):
                rec, reports = group.step({"i": i, "trace": False, "seed": seed}, me)
                records.append(rec)
                owner_of[i] = ranks.owners(reports, me.entry.n_batches)
            sample = ranks.check_sample(me.entry.w, owner_of, n)
            lines.append(readings(me.entry, records, sample, seed < first_seed + n_control,
                                  device, t0))
        group.stop(me)
    finally:
        group.close()
    return summarize(spec, lines)


def readings(entry, records, sample, control: bool, device, t0) -> dict:
    """One seed's line: the program's readings over ``sample`` and, with
    ``control``, the TF32 control's; printed, and returned."""
    walls = time.perf_counter() - t0
    line = {"seed": entry.w.seed, "failed": sum(bool(r["failed"]) for r in records),
            "program": {}, "control": {}}
    for r, batches in sample.items():
        ref = entry.reference(r, batches, "float64", device)
        for k, v in entry.compare(records[r], ref).items():
            line["program"][k] = max(v, line["program"].get(k, 0.0))
        if control:
            low = entry.as_record(entry.reference(r, batches, "tf32", device))
            for k, v in entry.compare(low, ref).items():
                line["control"][k] = max(v, line["control"].get(k, 0.0))
    line["seconds"] = {"requests": walls, "all": time.perf_counter() - t0}
    print(json.dumps(line), flush=True)
    return line


def summarize(spec, lines) -> int:
    """The summary line: the largest program and the smallest control
    reading of each number, beside the cell's limits."""
    program, control = {}, {}
    for line in lines:
        for k, v in line["program"].items():
            program[k] = max(v, program.get(k, 0.0))
        for k, v in line["control"].items():
            control[k] = min(v, control.get(k, float("inf")))
    print(json.dumps({"summary": spec["cell"]["name"], "program_max": program,
                      "control_min": control, "limits": spec["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
