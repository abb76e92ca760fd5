# -*- coding: utf-8 -*-
"""The port's multi-process runs (``remo3d_tpu_torch/parallel/distributed.py``
and the executor's ('batch', 'solve') split): two gloo processes on a free
local port run tests/_torch_distributed_worker.py, which mirrors
tests/_distributed_worker.py and holds the split logs to the single-process
ones; one process at world size 1 must give the unsplit log bit for bit.
Also the no-argument form of ``initialize_distributed`` outside a cluster."""

import os
import socket
import subprocess
import sys

import pytest

from remo3d_tpu_torch.parallel import distributed

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(world: int) -> list[str]:
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO_ROOT
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(port), str(world), str(rank)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"DISTRIBUTED_OK rank={rank} world={world}" in out, out
    return outs


def test_two_process_split_logs_match_single_process():
    _run_ranks(2)


def test_world_size_one_is_bitwise_unsplit():
    _run_ranks(1)


def test_no_argument_form_without_cluster_returns_false(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(distributed, "_init_attempted", False)
    assert distributed.initialize_distributed() is False
    assert distributed.world() == (0, 1) and not distributed.is_multiprocess()
    assert distributed.initialize_distributed() is False  # tried once


def test_no_argument_form_warns_on_a_broken_cluster(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "not-a-number")
    monkeypatch.setattr(distributed, "_init_attempted", False)
    with pytest.warns(RuntimeWarning, match="running as a single process"):
        assert distributed.initialize_distributed() is False
    monkeypatch.setattr(distributed, "_init_attempted", False)
    with pytest.raises(ValueError, match="together"):
        distributed.initialize_distributed(coordinator_address="localhost:1")
