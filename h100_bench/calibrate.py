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
of each number.
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
    from . import drive

    config, traffic = spec["config"], spec["traffic"]
    entry = drive.ENTRIES[traffic["entry"]](drive.Workload(config, traffic, first_seed), device)
    entry.request(-1)
    program, control = {}, {}
    for seed in range(first_seed, first_seed + n_seeds):
        t0 = time.perf_counter()
        entry.w = drive.Workload(config, traffic, seed)
        records = [entry.request(i) for i in range(n_requests)]
        walls = time.perf_counter() - t0
        line = {"seed": seed, "failed": sum(bool(r["failed"]) for r in records),
                "program": {}, "control": {}}
        for r, batches in entry.w.check_sample(n_requests, entry.n_batches).items():
            ref = entry.reference(r, batches, "float64", device)
            for k, v in entry.compare(records[r], ref).items():
                line["program"][k] = max(v, line["program"].get(k, 0.0))
            if seed < first_seed + n_control:
                low = entry.as_record(entry.reference(r, batches, "tf32", device))
                for k, v in entry.compare(low, ref).items():
                    line["control"][k] = max(v, line["control"].get(k, 0.0))
        line["seconds"] = {"requests": walls, "all": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            program[k] = max(v, program.get(k, 0.0))
        for k, v in line["control"].items():
            control[k] = min(v, control.get(k, float("inf")))
    print(json.dumps({"summary": spec["cell"]["name"], "program_max": program,
                      "control_min": control, "limits": spec["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
