# -*- coding: utf-8 -*-
"""Two pieces of the port's executor (``parallel/runtime.py``) on their own:
``_split_axes``, which splits a chunk's ranks between the batch axis and the
solve axis, and ``LazyGrids``, the per-batch grid sequence that builds each
grid on its first access."""

import pytest

from remo3d_tpu_torch.parallel.runtime import LazyGrids, _split_axes


@pytest.mark.parametrize("n_ranks,n_batches,n_solves,axes", [
    (1, 164, 5, (1, 1)),  # one process: nothing to split
    (4, 614, 5, (4, 1)),  # batches enough for every rank
    (2, 1, 4, (1, 2)),  # one batch: both ranks on its solves
    (4, 2, 6, (2, 2)),  # two batches: 2 ranks each, 3 slots a rank
    (8, 1, 4, (2, 4)),  # the solve axis takes at most the slots
    (4, 3, 5, (4, 1)),  # 5 slots share no divisor with 4 ranks
    (4, 1, 5, (4, 1)),
])
def test_split_axes(n_ranks, n_batches, n_solves, axes):
    """The solve axis takes ranks only when batches are scarcer than ranks,
    and then the largest count dividing both the slots and the ranks."""
    assert _split_axes(n_ranks, n_batches, n_solves) == axes


class Builder:
    """Builds grid i as the tuple ("grid", i) and records every call."""

    def __init__(self):
        self.calls = []

    def __call__(self, i):
        self.calls.append(i)
        return ("grid", i)


def test_lazy_grids_build_each_grid_once_on_first_access():
    build = Builder()
    grids = LazyGrids(5, build)
    assert len(grids) == 5 and build.calls == [] and grids.built == set()
    assert grids[3] == ("grid", 3)
    assert grids[3] is grids[3]
    assert build.calls == [3] and grids.built == {3}
    grids.ensure(2, 5)
    assert build.calls == [3, 2, 4] and grids.built == {2, 3, 4}
    assert list(grids) == [("grid", i) for i in range(5)]
    assert sorted(build.calls) == [0, 1, 2, 3, 4] and grids.built == set(range(5))


def test_lazy_grids_index_negative_and_slice_from_the_cache():
    build = Builder()
    grids = LazyGrids(6, build)
    last = grids[-1]
    assert last == ("grid", 5) and grids[5] is last and build.calls == [5]
    part = grids[1:6:2]
    assert part == [("grid", 1), ("grid", 3), ("grid", 5)] and part[2] is last
    assert build.calls == [5, 1, 3]
    assert grids[-5] is part[0]
    grids.ensure(-3, 100)  # clipped to 0..6
    assert grids.built == {0, 1, 2, 3, 4, 5} and build.calls == [5, 1, 3, 0, 2, 4]
    assert grids[:] == [("grid", i) for i in range(6)] and len(build.calls) == 6


def test_lazy_grids_raise_index_error_out_of_range():
    build = Builder()
    grids = LazyGrids(6, build)
    for index in (6, -7):
        with pytest.raises(IndexError):
            grids[index]
    assert build.calls == [] and grids.built == set()
