# -*- coding: utf-8 -*-
"""Runs of a cell over several processes, one card each.

A traffic file with ``"ranks": N`` makes a run an N-process run of the
program's multi-process path (``remo3d_tpu_torch.parallel.distributed``):

* The process that was started is rank 0. It checks that N cards are
  visible, then starts ranks 1 to N-1 as child processes
  (``python3 -m h100_bench.ranks``, new sessions) with the environment
  torchrun sets: MASTER_ADDR, a free MASTER_PORT, RANK, WORLD_SIZE and
  LOCAL_RANK. Every rank calls the program's ``initialize_distributed()``
  with no arguments and runs on its own card, ``cuda:<LOCAL_RANK>``.
* Rank 0 keeps the closed loop. Before each request it broadcasts one small
  message (the request, whether it is traced, the seed) or the stop. Every
  rank runs the request with the same inputs and gets the whole log back,
  and each rank's report (its phases, chunk rows and card) goes to rank 0
  by ``gather_object``. Rank 0's record is the request's record.
* With ``--trace 1`` every rank profiles its own card over the traced
  requests and keeps what the profiler saw.
* After the window every rank reads its memory peak, sends rank 0 what it
  read in its traced stretch (:func:`summary`) and releases its entry; the
  group is destroyed and the children exit. Only then does rank 0
  run the check, on a sample of batches drawn from the seed among each
  rank's share (:func:`owners`, :func:`check_sample`).

A rank that raises, dies or stops answering ends the run. A child that
raises exits at once, which breaks rank 0's next collective. Rank 0's
watchdog kills every child when one exits early or a step takes longer than
STALL_S (READ_S for a traced step and the stop); rank 0 then counts the
request as failed and gives its line with ``correct`` false. If rank 0
itself does not return within GRACE_S after that, the process exits 1 with
no line. The gloo group's own timeout never ends a run.
"""

from __future__ import annotations

import collections
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CHILD = (sys.executable, "-m", "h100_bench.ranks")
SETUP_S = 1200.0  # the set-up's limit: the first run in a checkout builds the kernels
STALL_S = 30.0  # the longest one step of the window may take
READ_S = 120.0  # the same for a traced step and the stop, where the ranks read their traces
GRACE_S = 15.0  # rank 0's time to return once the children are ended
TOP = 10


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def ranks_of(spec: dict) -> int:
    """The processes a run of the cell takes (1 without ``ranks``)."""
    return int(spec["traffic"].get("ranks", 1))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- every rank ------------------------------------------------------------------------


class Rank:
    """One rank's part of a run: its entry on its card, serving rank 0's
    messages."""

    def __init__(self, spec: dict, seed: int, device: str):
        import torch

        from . import drive

        self.spec = spec
        self.on_cuda = device.startswith("cuda")
        if self.on_cuda:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        self.sync = torch.cuda.synchronize if self.on_cuda else (lambda: None)
        self.entry = drive.ENTRIES[spec["traffic"]["entry"]](
            drive.Workload(spec["config"], spec["traffic"], seed), device)
        self.n_trace = int(spec["traffic"].get("trace_requests", 2))
        self.prof = self.stretch = None

    def serve(self, msg: dict) -> tuple[dict, dict]:
        """Request ``msg["i"]`` under ``msg["seed"]``; returns its record and
        this rank's report. The profiler starts at the first traced request
        and stops after request ``trace_requests``."""
        from . import drive
        from . import trace as tracing

        if msg["seed"] != self.entry.w.seed:  # calibration reads seed after seed
            self.entry.w = drive.Workload(self.spec["config"], self.spec["traffic"], msg["seed"])
        if msg["trace"] and self.prof is None:
            self.prof = tracing.profiler(self.on_cuda)
            self.prof.__enter__()
            self.h0, self.since_ns = time.perf_counter(), time.time_ns()
        t0 = time.perf_counter()
        rec = self.entry.request(msg["i"])
        rec["wall"] = time.perf_counter() - t0
        rep = self.entry.model.last_report
        report = {"wall": rec["wall"], "failed": rec["failed"], "phases": rec["phases"],
                  "chunks": rec["chunks"], "chunk": rep["chunk"], "axes": rep["axes"],
                  "device": rep["device"]}
        if msg["trace"] and msg["i"] == self.n_trace:
            self.sync()
            host_s = time.perf_counter() - self.h0
            self.prof.__exit__(None, None, None)
            self.stretch = tracing.read(self.prof, host_s)
            self.prof = None
        return rec, report

    def finish(self, read: bool = True) -> dict:
        """This rank's memory peak, with ``read`` the :func:`summary` of its
        traced stretch (None without one) and its foreign modules; the entry
        released."""
        import torch

        from .run import foreign_modules

        peak = torch.cuda.max_memory_allocated() if self.on_cuda else 0
        trace = summary(self.stretch, self.since_ns) if read and self.stretch else None
        self.entry.release()
        return {"peak": int(peak), "trace": trace, "foreign": foreign_modules()}


def summary(stretch, since_ns: int) -> dict:
    """What a rank sends rank 0 of its traced stretch: its card's busy and
    the stretch's host seconds, the device seconds by kernel name, the idle
    time credited to the rank's spans and its wait for the other ranks."""
    from . import spans
    from . import trace as tracing

    ops = collections.defaultdict(float)
    for name, s, e in stretch.activities:
        ops[name[:tracing.NAME_CHARS]] += (e - s) / 1e9
    return {"busy_s": stretch.busy_s(), "host_s": stretch.host_s,
            "n_activities": len(stretch.activities), "ops": dict(ops),
            "idle_by_span": spans.idle_by_span({"stretch": stretch}),
            "rank_wait_s": spans.rank_wait_s_per_log(since_ns)}


# ---- rank 0 ----------------------------------------------------------------------------


class Group:
    """Rank 0's side: ranks 1 to N-1 as child processes, the process group
    with them, and a watchdog that ends every rank when one exits early or a
    step overruns its limit."""

    def __init__(self, n: int, child=CHILD):
        self.n, self.child = n, list(child)
        self.children: list = []
        self.deadline = None  # time.monotonic() by which the current step ends
        self.stopping = False
        self.reason = None
        self.lock = threading.Lock()
        self.done = threading.Event()
        self.watchdog = None

    def start(self, setup: dict) -> None:
        """Start the children, join the group and send them ``setup``."""
        import torch.distributed as dist

        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                   WORLD_SIZE=str(self.n))
        self.deadline = time.monotonic() + SETUP_S
        for r in range(1, self.n):
            # Their output goes to standard error: the result line is rank 0's.
            child = subprocess.Popen(self.child, cwd=ROOT, stdin=subprocess.DEVNULL, stdout=2,
                                     env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                                     start_new_session=True)
            self.children.append(child)
            log(f"h100_bench: rank {r} pid {child.pid}")
        os.environ.update({k: env[k] for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE")},
                          RANK="0", LOCAL_RANK="0")
        self.watchdog = threading.Thread(target=self._watch, name="h100-bench-watchdog",
                                         daemon=True)
        self.watchdog.start()
        from remo3d_tpu_torch.parallel.distributed import initialize_distributed

        if not initialize_distributed():
            raise RuntimeError("the process group did not form")
        dist.broadcast_object_list([setup], src=0)

    def step(self, msg: dict, me: Rank, limit: float | None = None) -> tuple[dict, list]:
        """``msg`` to every rank and rank 0's own part of it, within ``limit``
        seconds (STALL_S by default); returns rank 0's record and every
        rank's report, in rank order."""
        import torch.distributed as dist

        self.deadline = time.monotonic() + (STALL_S if limit is None else limit)
        dist.broadcast_object_list([msg], src=0)
        rec, report = me.serve(msg)
        reports = [None] * self.n
        dist.gather_object(report, reports, dst=0)
        self.deadline = None
        return rec, reports

    def stop(self, me: Rank) -> list:
        """The stop to every rank: each one's :meth:`Rank.finish`, in rank
        order; the group destroyed and the children ended."""
        import torch.distributed as dist

        self.stopping = True
        self.deadline = time.monotonic() + READ_S
        dist.broadcast_object_list([{"stop": True}], src=0)
        finals = [None] * self.n
        dist.gather_object(me.finish(), finals, dst=0)
        dist.destroy_process_group()
        for r, child in enumerate(self.children, 1):
            code = child.wait(timeout=max(1.0, self.deadline - time.monotonic()))
            if code != 0:
                raise RuntimeError(f"rank {r} exited with code {code} after the stop")
        self.deadline = None
        return finals

    def fail(self, reason: str) -> None:
        """End every child, once, saying why."""
        with self.lock:
            if self.reason is None:
                self.reason = reason
                log(f"h100_bench: {reason}; ending every rank")
        self.kill()

    def kill(self) -> None:
        for child in self.children:
            try:
                os.killpg(child.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        for child in self.children:
            child.wait()

    def close(self) -> None:
        """No child left; the watchdog stopped."""
        self.kill()
        self.done.set()
        if self.watchdog is not None and self.watchdog is not threading.current_thread():
            self.watchdog.join(timeout=GRACE_S)

    def _watch(self) -> None:
        while not self.done.wait(0.2):
            dead = [(r, c.returncode) for r, c in enumerate(self.children, 1)
                    if c.poll() is not None and not (self.stopping and c.returncode == 0)]
            deadline = self.deadline
            if dead:
                self.fail(f"rank {dead[0][0]} exited with code {dead[0][1]}")
            elif deadline is not None and time.monotonic() > deadline:
                self.fail("a step overran its limit")
            else:
                continue
            if not self.done.wait(GRACE_S):
                log("h100_bench: rank 0 did not return once the other ranks had ended")
                os._exit(1)
            return


def owners(reports: list, n_batches: int) -> list:
    """owner[b]: the rank that solved batch b of one request, read from the
    ranks' reports: each rank's chunk rows say how many batches it solved in
    each chunk of ``chunk`` batches, and a chunk's shares follow one another
    in rank order from the chunk's first batch, as the program's executor
    lays them out (``share`` in ``parallel/runtime.py``). Raises ValueError
    when the rows do not cover the plan's batches once each."""
    chunk, n_chunks = reports[0]["chunk"], len(reports[0]["chunks"])
    owner = []
    for j in range(n_chunks):
        if len(owner) != j * chunk:
            raise ValueError(f"chunk {j}: the ranks' rows cover {len(owner) - j * chunk:+d} "
                             "batches against the chunk's")
        for q, rep in enumerate(reports):
            if rep["axes"]["solve"] != 1 or rep["chunk"] != chunk or len(rep["chunks"]) != n_chunks:
                raise ValueError(f"rank {q}'s report does not split the batches as rank 0's")
            owner += [q] * rep["chunks"][j]["batches"]
    if len(owner) != n_batches:
        raise ValueError(f"the ranks' rows cover {len(owner)} batches of {n_batches}")
    return owner


def check_sample(w, owner_of: dict, n: int) -> dict:
    """{request: [batch, ...]}: the (request, batch) pairs the check compares,
    drawn from the seed, ``check.batches`` // n among each rank's share of
    the window's pairs (``owner_of``: {request: :func:`owners`}) and the rest
    among all, so that every rank's answers are compared."""
    k = int(w.traffic["check"]["batches"])
    rng = np.random.default_rng([w.seed % 2**63, 0, 2])
    pairs = [(r, b) for r in sorted(owner_of) for b in range(len(owner_of[r]))]
    picked: set = set()
    for q in range(n):
        share = [p for p in pairs if owner_of[p[0]][p[1]] == q]
        for j in rng.choice(len(share), size=min(k // n, len(share)), replace=False):
            picked.add(share[j])
    rest = [p for p in pairs if p not in picked]
    for j in rng.choice(len(rest), size=min(k - len(picked), len(rest)), replace=False):
        picked.add(rest[j])
    out: dict = {}
    for r, b in sorted(picked):
        out.setdefault(r, []).append(b)
    return out


def run(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, child=CHILD) -> dict | None:
    """One run of a cell over :func:`ranks_of` processes; returns the result
    line's object, or None where the run cannot give one (fewer cards than
    ranks, a failure in set-up, a child holding a foreign module). ``device``
    "cpu" and ``child`` are for the tests."""
    import torch

    n = ranks_of(spec)
    if device.startswith("cuda") and torch.cuda.device_count() < n:
        log(f"h100_bench: the cell runs {n} ranks, one card each; "
            f"{torch.cuda.device_count()} visible")
        return None
    group = Group(n, child)
    try:
        return _run(group, spec, seed, seconds, trace, device, t_start)
    except Exception:
        log(f"h100_bench: the run could not go on:\n{traceback.format_exc()}")
        return None
    finally:
        group.close()


def _run(group: Group, spec, seed, seconds, trace, device, t_start) -> dict | None:
    import torch

    from . import drive
    from . import run as runner

    n, on_cuda = group.n, device.startswith("cuda")
    traffic = spec["traffic"]
    group.start({"spec": spec, "seed": seed, "device": device})
    me = Rank(spec, seed, device)
    warm, reports = group.step({"i": -1, "trace": False, "seed": seed}, me, SETUP_S)
    if warm["failed"]:
        log("h100_bench: the warm request failed")
    cards = [r["device"] for r in reports]
    log(f"h100_bench: ranks 0-{n - 1} on {' '.join(cards)}")
    if on_cuda and cards != [f"cuda:{q}" for q in range(n)]:
        raise RuntimeError(f"the ranks do not run one to a card: {cards}")
    me.sync()
    setup_s = time.perf_counter() - (runner.T_START if t_start is None else t_start)
    log(f"h100_bench: {spec['cell']['name']} seed {seed}: set-up {setup_s:.3f} s")

    n_trace = int(traffic.get("trace_requests", 2)) if trace else 0
    records, per_rank, broken = [], [[] for _ in range(n)], False
    t0 = time.perf_counter()
    while len(records) < 1 + n_trace or time.perf_counter() - t0 < seconds:
        i = len(records)
        t_req = time.perf_counter()
        try:
            traced = 1 <= i <= n_trace
            rec, reports = group.step({"i": i, "trace": traced, "seed": seed}, me,
                                      READ_S if traced else None)
        except Exception:
            log(f"h100_bench: request {i} raised:\n{traceback.format_exc()}")
            group.fail(f"request {i} did not complete")
            records.append({"failed": True, "work": 0, "wall": time.perf_counter() - t_req})
            broken = True
            break
        records.append(rec)
        for q, rep in enumerate(reports):
            per_rank[q].append(rep)
    window_s = time.perf_counter() - t0
    attempted = len(records)
    failed = sum(bool(r["failed"]) for r in records)
    log(f"h100_bench: window {window_s:.3f} s, {attempted} requests ({failed} failed), walls "
        + " ".join(f"{r['wall']:.3f}" for r in records))

    if broken:
        finals = [me.finish(read=False)]
    else:
        finals = group.stop(me)
        foreign = sorted({m for f in finals for m in f["foreign"]})
        if foreign:
            log(f"h100_bench: a rank holds {foreign}")
            return None
    group.close()

    traces = [None] * n if broken else [f["trace"] for f in finals]
    ctx = {"records": records, "traced": records[1:1 + n_trace], "stretch": None,
           "window_s": window_s, "setup_s": setup_s, "workload": me.entry.w,
           "ranks": [{"records": reps, "trace": t} for reps, t in zip(per_rank, traces)]}
    out = {"correct": False, "attempted": attempted, "failed": failed,
           "metrics": runner.measure(spec, ctx, trace),
           "device": {"platform": "gpu", "kind": torch.cuda.get_device_name() if on_cuda
                      else "cpu", "count": n,
                      "memory_peak_bytes": max(f["peak"] for f in finals)}}
    if trace and not broken and all(traces):
        out["device"].update(busy_s=sum(t["busy_s"] for t in traces) / n,
                             window_s=traces[0]["host_s"])
        out["breakdown"] = breakdown(traces)

    numbers = {}
    if not broken:
        # ---- the check, with every rank's state freed ----------------------------------
        t1 = time.perf_counter()
        try:
            owner_of = {r: owners([reps[r] for reps in per_rank], me.entry.n_batches)
                        for r in range(attempted)}
        except ValueError as e:
            log(f"h100_bench: no owner for the check's batches: {e}")
        else:
            sample = check_sample(me.entry.w, owner_of, n)
            numbers = drive.check(me.entry, records, device, sample)
        log(f"h100_bench: check ({time.perf_counter() - t1:.1f} s)")
    return runner.judge(out, spec, numbers)


def breakdown(traces: list) -> dict:
    """The device seconds by kernel name summed over the cards, and the
    longest idle times of any card by the span its host was in."""
    ops = collections.Counter()
    for t in traces:
        ops.update(t["ops"])
    idle = [[f"rank {q}: {name}", s] for q, t in enumerate(traces)
            for name, s in (t["idle_by_span"] or {}).items()]
    idle.sort(key=lambda g: -g[1])
    return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)], "idle_gaps": idle[:TOP]}


# ---- ranks 1 to N-1 ----------------------------------------------------------------------


def _orphaned(parent: int) -> None:
    """End this process once rank 0, its parent, has gone."""
    while True:
        time.sleep(0.5)
        if os.getppid() != parent:
            os._exit(1)


def child() -> int:
    """A rank started by rank 0: join the group, take the set-up, serve
    rank 0's messages until the stop."""
    from .run import THREAD_VARS

    for var in THREAD_VARS:
        os.environ.setdefault(var, "1")
    threading.Thread(target=_orphaned, args=(os.getppid(),), daemon=True).start()
    import torch.distributed as dist

    from remo3d_tpu_torch.parallel.distributed import initialize_distributed

    if not initialize_distributed():
        log(f"h100_bench: rank {os.environ.get('RANK')}: the process group did not form")
        return 1

    def receive():
        box = [None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    setup = receive()
    me = Rank(setup["spec"], setup["seed"], setup["device"])
    while True:
        msg = receive()
        if msg.get("stop"):
            dist.gather_object(me.finish(), None, dst=0)
            break
        dist.gather_object(me.serve(msg)[1], None, dst=0)
    dist.destroy_process_group()
    return 0


def main() -> None:
    """A child's entry point. Any exception ends the process at once: its
    sockets close, so the other ranks' collectives fail instead of waiting."""
    try:
        code = child()
    except BaseException:
        log(f"h100_bench: rank {os.environ.get('RANK')} raised:\n{traceback.format_exc()}")
        code = 1
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    main()
