# -*- coding: utf-8 -*-
"""``checkpoint`` and ``profile_dir`` of the port's ``Model.simulate_logs``, on
the CPU and a small grid.

The checkpoint cases mirror tests/test_model.py::test_checkpoint_resume: a
finished checkpoint is returned as it is (poisoned results come back
verbatim), and a change of ``tol``, of a same-shape formation or of the
measurement count recomputes. A run broken after its first chunk resumes,
solves only the chunks that are missing and equals an unbroken run. The
profile trace names the port's chunk solve."""

import glob
import os

import numpy as np
import pytest
import torch

from remo3d_tpu_torch import Model
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D
from remo3d_tpu_torch.parallel import runtime

torch.set_num_threads(2)

SMALL_2D = GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2)
FAST = dict(grid_spec=SMALL_2D, device="cpu", preconditioner="direct", verbose=False)
TOOL = "A2.0M0.5N"
FORMATION = np.array([
    [-100.0, -0.5, np.nan, np.nan, 10.0],
    [-0.5, 0.6, 0.3, 4.0, 30.0],
    [0.6, 100.0, np.nan, np.nan, 5.0],
])
BOREHOLE = np.array([[-100.0, 0.1, 1.0], [100.0, 0.1, 1.0]])


def uniform_models(rho=7.0, rad=0.118):
    formation = np.array([[-100.0, 100.0, np.nan, np.nan, rho]])
    borehole = np.array([[-100.0, rad, rho], [100.0, rad, rho]])
    return formation, borehole


def log(formation, borehole, depths, tools=(TOOL,), **kwargs):
    m = Model(list(tools))
    m.set_model_parameters(formation, borehole, borehole_geometry_type="radius")
    m.initialize_workers(cpu_workers=1)
    m.simulate_logs(depths, **{**FAST, **kwargs})
    return m


class CountingSolve:
    """Wraps the 2D direct chunk solve: counts calls, and raises at call
    ``fail_at`` (1-based) to break a run."""

    def __init__(self, fail_at=None):
        self.calls = 0
        self.fail_at = fail_at
        self.inner = runtime._solve_chunk_direct

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("run broken on purpose")
        return self.inner(*args, **kwargs)


def test_checkpoint_resume(tmp_path):
    rho = 5.0
    formation, borehole = uniform_models(rho)
    ckpt = str(tmp_path / "run.npz")
    depths = np.array([0.0, 0.1])

    def run(**kw):
        return log(formation, borehole, depths, checkpoint=ckpt, **kw).logs[TOOL][:, 1]

    v1 = run()
    assert np.allclose(v1, rho, rtol=0.02)
    assert os.path.exists(ckpt)

    # Poison the stored results: a resumed run returns them verbatim.
    saved = dict(np.load(ckpt, allow_pickle=False))
    saved["results"] = saved["results"] * 0 + 123.0
    np.savez(ckpt, **saved)
    assert np.allclose(run(), 123.0)

    # A solver-config change (tol) changes the key: full recompute.
    v3 = run(tol=1e-7)
    assert np.allclose(v3, rho, rtol=0.02), v3

    # A same-shape model change invalidates too (content hash).
    np.savez(ckpt, **saved)
    formation2 = formation.copy()
    formation2[0, 4] = 2 * rho
    m = log(formation2, borehole, depths, checkpoint=ckpt)
    assert not np.allclose(m.logs[TOOL][:, 1], 123.0)

    # A different measurement count changes the key.
    np.savez(ckpt, **saved)
    m = log(formation, borehole, np.array([0.0]), checkpoint=ckpt)
    assert np.allclose(m.logs[TOOL][:, 1], rho, rtol=0.02)


def test_broken_run_resumes(tmp_path, monkeypatch):
    """Four chunks; the run breaks in its second chunk solve. The rerun solves
    the three missing chunks only and equals an unbroken run; a third run
    solves nothing."""
    depths = np.arange(-0.6, 0.61, 0.2)
    kw = dict(tools=(TOOL, "B5.7A0.4M"), batch_size=1, executor_overrides={"chunk_size": 4})
    whole = log(FORMATION, BOREHOLE, depths, **kw)
    n_chunks = len(whole.last_report["chunks"])
    assert n_chunks == 4
    ckpt = str(tmp_path / "broken.npz")

    broken = CountingSolve(fail_at=2)
    monkeypatch.setattr(runtime, "_solve_chunk_direct", broken)
    with pytest.raises(RuntimeError, match="broken on purpose"):
        log(FORMATION, BOREHOLE, depths, checkpoint=ckpt, **kw)
    assert len(np.load(ckpt)["done_chunks"]) == 1

    resumed = CountingSolve()
    monkeypatch.setattr(runtime, "_solve_chunk_direct", resumed)
    m = log(FORMATION, BOREHOLE, depths, checkpoint=ckpt, **kw)
    assert resumed.calls == n_chunks - 1
    assert m.last_report["resumed_chunks"] == 1
    for t in whole.logs:
        np.testing.assert_allclose(m.logs[t], whole.logs[t], rtol=1e-12)

    again = CountingSolve()
    monkeypatch.setattr(runtime, "_solve_chunk_direct", again)
    m = log(FORMATION, BOREHOLE, depths, checkpoint=ckpt, **kw)
    assert again.calls == 0
    for t in whole.logs:
        np.testing.assert_array_equal(m.logs[t], whole.logs[t])


def test_profile_dir_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    m = log(FORMATION, BOREHOLE, np.array([0.0, 0.2]), profile_dir=str(trace_dir))
    files = glob.glob(str(trace_dir / "*.json"))
    assert len(files) == 1 and m.last_report["profile_trace"] == files[0]
    text = open(files[0]).read()
    assert "remo3d_tpu_torch.solve_chunk" in text
    assert np.isfinite(m.logs[TOOL][:, 1]).all()


_CHECKPOINT_KEY = runtime.Executor._checkpoint_key


def key_of_run(monkeypatch, path, formation=FORMATION, **kwargs):
    """(key, executor, arguments) of the one checkpoint key that a 2-depth
    log checkpointed into ``path`` computes."""
    calls = []

    def spy(self, *args):
        key = _CHECKPOINT_KEY(self, *args)
        calls.append((key, self, args))
        return key

    monkeypatch.setattr(runtime.Executor, "_checkpoint_key", spy)
    log(formation, BOREHOLE, np.array([0.0, 0.2]), checkpoint=str(path), **kwargs)
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("change", ["none", "tol", "n_ranks", "resistivity"])
def test_checkpoint_key(tmp_path, monkeypatch, change):
    """The same inputs give the same key; another tolerance, another world
    size or a same-shape formation with one resistivity edited gives another,
    whose shape part (measurements x tools | batches x slots | grid) is the
    same."""
    key, executor, args = key_of_run(monkeypatch, tmp_path / "a.npz")
    if change == "none":
        other = key_of_run(monkeypatch, tmp_path / "b.npz")[0]
    elif change == "tol":
        other = key_of_run(monkeypatch, tmp_path / "b.npz", tol=1e-6)[0]
    elif change == "n_ranks":
        *head, n_ranks, grid_shape = args
        assert n_ranks == 1
        other = _CHECKPOINT_KEY(executor, *head, 2, grid_shape)
    else:
        edited = FORMATION.copy()
        edited[1, 4] = 31.0
        other = key_of_run(monkeypatch, tmp_path / "b.npz", formation=edited)[0]
    assert (other == key) == (change == "none")
    assert other.split("|")[:3] == key.split("|")[:3]
