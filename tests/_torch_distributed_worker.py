# -*- coding: utf-8 -*-
"""One rank of the port's multi-process test (tests/test_torch_distributed.py).

Run as: python _torch_distributed_worker.py <port> <world size> <rank>

Imports torch, numpy and the port, never JAX. Before it joins the process
group it runs the single-process reference logs; then it initializes
``torch.distributed`` (gloo, tcp://localhost:<port>) and checks:

(a) ``initialize_distributed`` / ``is_multiprocess`` / ``gather_result``;
(b) a float64 2D log split on the batch axis equals the single-process log
    within 1e-10 relative;
(c) a float64 log of one batch (``batch_size=4``) split on the solve axis,
    equal likewise;
(d) the dry-run certificate of ``__graft_entry__.dryrun_multichip`` on the
    port: a 2D "bcr" and a 3D direct chunk solve, each split over the ranks,
    converge (residual <= tol, iterations under the cap) on every rank.

At world size 1 it checks instead that the log after ``initialize_distributed``
is bitwise the log before it. The last line is ``DISTRIBUTED_OK rank=<r> ...``.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from remo3d_tpu_torch import Model  # noqa: E402
from remo3d_tpu_torch.meshing.carve import carve_local_model  # noqa: E402
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D, build_grid2d  # noqa: E402
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D, build_grid3d  # noqa: E402
from remo3d_tpu_torch.parallel import distributed, runtime  # noqa: E402

torch.set_num_threads(1)

FORMATION = np.array([
    [-100.0, -0.5, np.nan, np.nan, 10.0],
    [-0.5, 0.6, 0.3, 4.0, 30.0],
    [0.6, 100.0, np.nan, np.nan, 5.0],
])
BOREHOLE = np.array([[-100.0, 0.1, 1.0], [100.0, 0.1, 1.0]])
SPEC = GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2)
TOOLS = ["A2.0M0.5N", "B5.7A0.4M"]


def batch_axis_log():
    """(b): 14 measurements of two tools in batches of 1, chunks of 4."""
    m = Model.compute_synthetic_logs(
        TOOLS, np.arange(-0.6, 0.61, 0.2), FORMATION, BOREHOLE,
        borehole_geometry_type="radius", grid_spec=SPEC, device="cpu", dtype="float64",
        tol=1e-12, batch_size=1, verbose=False, executor_overrides={"chunk_size": 4})
    return np.stack([m.logs[t][:, 1] for t in TOOLS], axis=1), m.last_report


def solve_axis_log():
    """(c): one batch of 4 solves."""
    m = Model.compute_synthetic_logs(
        TOOLS[:1], np.array([-0.3, -0.1, 0.1, 0.3]), FORMATION, BOREHOLE,
        borehole_geometry_type="radius", grid_spec=SPEC, device="cpu", dtype="float64",
        tol=1e-12, batch_size=4, verbose=False)
    return m.logs[TOOLS[0]][:, 1:2], m.last_report


def tiny_chunk(dim, n_batches, n_solves):
    """Stacked float32 inputs of a tiny 2D (65x17) or 3D (33x9x17) chunk, as
    ``__graft_entry__._tiny_problem*`` builds them."""
    if dim == "2D":
        formation = np.array([[-100.0, -1.0, np.nan, np.nan, 10.0],
                              [-1.0, 1.0, 0.3, 4.0, 20.0],
                              [1.0, 100.0, np.nan, np.nan, 8.0]])
        lm = carve_local_model(formation, np.array([[-100.0, 0.12], [100.0, 0.12]]), 1.1,
                               0.0, 50.0)
        grid = build_grid2d(GridSpec2D(nz=65, nr=17, n_wall_cells=3, n_blend_cells=2), 50.0,
                            lm, np.array([-2.5, -2.0, 0.0]), np.array([0.0]))
    else:
        formation = np.array([[-100.0, -1.0, np.nan, np.nan, 10.0],
                              [-1.0, 1.0, np.nan, np.nan, 100.0],
                              [1.0, 100.0, np.nan, np.nan, 10.0]])
        lm = carve_local_model(formation, np.array([[-100.0, 0.1], [100.0, 0.1]]), 1.0, 0.0,
                               50.0, dip_rad=0.35)
        grid = build_grid3d(GridSpec3D(nz=33, np_=9, nr=17, n_wall_cells=3, n_blend_cells=2),
                            50.0, lm, 0.35, np.array([-2.0, 0.0, 2.0]), np.array([0.0]))

    def stack(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(a, (n_batches,) + a.shape).astype(dtype)))

    src_i = torch.full((n_batches, n_solves, 2), grid.axis_node_index(0.0), dtype=torch.int64)
    src_fac = torch.zeros((n_batches, n_solves, 2))
    src_fac[:, :, 0] = 1.0
    return (stack(grid.coords, np.float32), stack(grid.sigma_cells, np.float32),
            stack(grid.free_mask, bool), src_i, src_fac)


def dryrun_certificate(rank, world):
    """(d): the 2D "bcr" chunk split over the ranks on the batch axis, the 3D
    direct chunk on the solve axis; every rank's residuals gathered."""
    out = {}
    args = tiny_chunk("2D", 2 * world, 2)
    mine = [a[2 * rank: 2 * rank + 2] for a in args]
    _, rel, iters = runtime._solve_chunk_direct(*mine, tol=1e-7, maxiter=50, schedule="bcr")
    out["2D"] = (distributed.gather_result(rel.reshape(1, -1)), iters, 1e-7, 50)
    args = tiny_chunk("3D", 1, 2 * world)
    mine = [*args[:3], args[3][:, 2 * rank: 2 * rank + 2], args[4][:, 2 * rank: 2 * rank + 2]]
    _, rel, iters = runtime._solve_chunk_3d(*mine, tol=1e-6, maxiter=100, precond="direct",
                                            schedule="scan", metric="cylindrical")
    out["3D"] = (distributed.gather_result(rel.reshape(1, -1)), iters, 1e-6, 100)
    all_iters = distributed.gather_result(np.array([[out["2D"][1], out["3D"][1]]]))
    for k, (dim, (rels, _, tol, cap)) in enumerate(out.items()):
        assert rels.shape[0] == world, (dim, rels.shape)
        assert np.isfinite(rels).all() and rels.max() <= tol, (dim, rels)
        assert (all_iters[:, k] < cap).all(), (dim, all_iters)
    return {dim: (float(v[0].max()), int(v[1])) for dim, v in out.items()}


def main():
    port, world, rank = (int(a) for a in sys.argv[1:4])
    ref_b, _ = batch_axis_log()
    ref_c, _ = solve_axis_log()
    assert not distributed.is_multiprocess()
    ok = distributed.initialize_distributed(f"localhost:{port}", world, rank)
    assert ok, "initialize_distributed returned False under explicit arguments"
    assert distributed.initialize_distributed() is True  # idempotent
    assert distributed.world() == (rank, world)
    if world == 1:
        got, report = batch_axis_log()
        assert report["world_size"] == 1
        np.testing.assert_array_equal(got, ref_b)
        print(f"DISTRIBUTED_OK rank={rank} world=1 bitwise", flush=True)
        return
    assert distributed.is_multiprocess()

    # (a) the helpers
    x = np.arange(6.0).reshape(2, 3) + 10 * rank
    tiled = distributed.gather_result(torch.from_numpy(x))
    np.testing.assert_array_equal(tiled, np.concatenate([np.arange(6.0).reshape(2, 3) + 10 * r
                                                         for r in range(world)]))
    owned = np.zeros((world, 2), dtype=bool)
    owned[rank] = True
    vals = np.full((world, 2), np.nan)
    vals[rank] = [rank, np.nan]  # the owner's NaN (a failed solve) must survive
    merged = distributed.gather_result(vals, owned)
    np.testing.assert_array_equal(merged, np.array([[r, np.nan] for r in range(world)]))
    assert distributed.sum_over_ranks([1, rank]) == [world, sum(range(world))]

    # (b) batch axis
    got_b, rep_b = batch_axis_log()
    assert rep_b["axes"] == {"batch": world, "solve": 1}, rep_b["axes"]
    assert rep_b["n_failed_solves"] == 0 and rep_b["world_size"] == world
    assert sum(c["batches"] for c in rep_b["chunks"]) < 14  # a share, not the whole
    rel_b = float(np.max(np.abs(got_b / ref_b - 1)))
    assert np.isfinite(got_b).all() and rel_b <= 1e-10, rel_b

    # (c) solve axis
    got_c, rep_c = solve_axis_log()
    assert rep_c["axes"] == {"batch": 1, "solve": world}, rep_c["axes"]
    assert [c["solves"] for c in rep_c["chunks"]] == [4 // world]
    rel_c = float(np.max(np.abs(got_c / ref_c - 1)))
    assert np.isfinite(got_c).all() and rel_c <= 1e-10, rel_c

    # (d) the dry-run certificate
    cert = dryrun_certificate(rank, world)
    print(f"DISTRIBUTED_OK rank={rank} world={world} batch_axis={rel_b:.1e} "
          f"solve_axis={rel_c:.1e} certificate={cert}", flush=True)


if __name__ == "__main__":
    main()
