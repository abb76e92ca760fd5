# -*- coding: utf-8 -*-
"""The phase-group runner of chip_smoke.py (``run_child``): a child that hangs
is cut at its limit and reported, together with the processes it started; a
child's last output line is passed back as JSON and the rest is echoed. The
runner imports neither torch nor jax, so these run on the CPU; the same cut
of a stalled CUDA launch is tests/test_torch_cuda.py::test_stalled_launch_is_cut."""

import os
import sys
import time

from chip_smoke import run_child


def test_runner_cuts_a_sleeping_child():
    run = run_child([sys.executable, "-c",
                     "import time; print('started', flush=True); time.sleep(120)"], 2, echo=False)
    assert run["status"] == "cut" and run["returncode"] == 124
    assert run["seconds"] < 15 and run["result"] is None
    assert run["tail"] == ["started"]


def test_runner_ends_the_childs_own_children():
    """The cut reaches the child's whole process group: a grandchild that
    sleeps on is gone too."""
    code = (
        "import subprocess, sys, time\n"
        "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(120)'])\n"
        "print(p.pid, flush=True)\n"
        "time.sleep(120)\n"
    )
    run = run_child([sys.executable, "-c", code], 3, echo=False)
    assert run["status"] == "cut"
    pid = int(run["tail"][0])
    for _ in range(50):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        raise AssertionError(f"grandchild {pid} outlived the cut")


def test_runner_passes_the_last_json_line(capsys):
    code = "import json; print('phase 3: fine'); print(); print(json.dumps({'k1': {'ms': 0.29}}))"
    run = run_child([sys.executable, "-c", code], 60)
    assert run["status"] == "ok" and run["returncode"] == 0
    assert run["result"] == {"k1": {"ms": 0.29}}
    out = capsys.readouterr().out
    assert "phase 3: fine" in out and "k1" not in out


def test_runner_reports_a_failed_child():
    run = run_child([sys.executable, "-c", "print('before'); raise SystemExit(3)"], 60, echo=False)
    assert run["status"] == "failed" and run["returncode"] == 3
    run = run_child([sys.executable, "-c", "print('no result line')"], 60, echo=False)
    assert run["status"] == "failed" and run["result"] is None
