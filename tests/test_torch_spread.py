# -*- coding: utf-8 -*-
"""The float32-vs-float64 spread of the 2D log, the port against the JAX
package, on the CPU with the direct preconditioner ("scan").

The spread of a package is |Ra_f32 / Ra_f64 - 1| over a log's readouts: the
float32 log at the default tolerance (3e-7) against the float64 log of the
same plan at tol 1e-10. Inputs: chip_smoke.py's phase-4 workload (its inline
BM2-like invaded formation and Example_01's six tools), 6 depths on a 193x41
grid.

The float64 logs of the two packages agree to 1e-10 (measured 4.9e-12): one
discretization. Their float32 logs do not: the port's operator closes the
zero row sums of the FEM stencil (its diagonal is minus the float64 sum of
the row's couplings, ``ops/assembly2d.py``) and its CG matvec is in
difference form (``kernels/stencil2d.py``), so its float32 log sits closer to
the float64 one than the JAX package's. The largest readout of a spread is a
sample of the noise (the JAX package's own maximum moves with XLA's CPU
configuration), so the test holds the root mean square of the port's spread
to at most the JAX package's (measured 2.82e-5 against 4.59e-5 on these 6
depths) and both maxima under the 1e-3 that chip_smoke.py allows a float32
log against the float64 one; and the assembled float32 stencil's row sums to
within an ulp of its diagonal.

Run as a script for the full-width measurement (the default 761x161 grid,
all 101 depths of phase 4, so every tool's worst depth is in), which prints
both spreads per tool:

    JAX_PLATFORMS=cpu python tests/test_torch_spread.py

(~20-25 min on 8 CPU cores). With ``--chunk`` it takes the one batch at
7.45 m apart instead (~1 min): the readout errors of each package's solve,
of the port's solve through the full 9-point (diagonal-form) apply, and of
each package's float32 system solved exactly (in float64). Never set the
thread count before these: a CPU build of torch with oneMKL has been seen to
hang inverting 161x161 float32 blocks after ``torch.set_num_threads``.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import remo3d_tpu  # noqa: E402
import remo3d_tpu_torch  # noqa: E402
from chip_smoke import BOREHOLE, DEPTHS, EXAMPLE01_TOOLS, FORMATION  # noqa: E402
from remo3d_tpu.meshing.grid2d import GridSpec2D as JSpec  # noqa: E402
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D as TSpec  # noqa: E402

SMALL = dict(nz=193, nr=41, n_wall_cells=6, n_blend_cells=3)
SMALL_DEPTHS = DEPTHS[[10, 25, 40, 55, 70, 85]]


def spread_logs(package, dtype, depths, grid=None):
    """One direct-scan log of ``package`` ("port" or "jax") on the CPU:
    (n_depths, 6 tools) readouts (NaN where a solve failed)."""
    tol = 1e-10 if dtype == "float64" else None
    common = dict(borehole_geometry_type="radius", dtype=dtype, tol=tol, verbose=False,
                  preconditioner="direct", executor_overrides={"direct_schedule": "scan"})
    if package == "port":
        spec = {} if grid is None else {"grid_spec": TSpec(**grid)}
        m = remo3d_tpu_torch.Model.compute_synthetic_logs(
            EXAMPLE01_TOOLS, depths, FORMATION, BOREHOLE, device="cpu", **spec, **common)
    else:
        spec = {} if grid is None else {"grid_spec": JSpec(**grid)}
        m = remo3d_tpu.Model.compute_synthetic_logs(
            EXAMPLE01_TOOLS, depths, FORMATION, BOREHOLE, platform="cpu", **spec, **common)
    return np.stack([m.logs[t][:, 1] for t in EXAMPLE01_TOOLS], axis=1)


def spreads(depths, grid=None):
    """({package: (n_depths, 6) |f32/f64 - 1|}, max |port_f64 / jax_f64 - 1|)."""
    out, f64s = {}, {}
    for package in ("port", "jax"):
        f32 = spread_logs(package, "float32", depths, grid)
        f64s[package] = spread_logs(package, "float64", depths, grid)
        assert np.isfinite(f32).all() and np.isfinite(f64s[package]).all()
        out[package] = np.abs(f32 / f64s[package] - 1)
    return out, float(np.max(np.abs(f64s["port"] / f64s["jax"] - 1)))


def rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def test_float32_spread_matches_jax():
    s, f64_rel = spreads(SMALL_DEPTHS, SMALL)
    assert f64_rel <= 1e-10, f64_rel
    port, jax = rms(s["port"]), rms(s["jax"])
    assert 0 < port <= 1.0 * jax, (port, jax)
    assert max(s["port"].max(), s["jax"].max()) <= 1e-3


def test_float32_stencil_rows_sum_to_zero():
    """On a seeded random grid (a tensor grid with jittered nodes, random
    conductivities over 4 decades), every row of the assembled float32
    stencil sums to within an ulp of its diagonal (the sum taken in float64),
    and the half storage's row-sum plane is that sum, rounded once."""
    import torch

    from remo3d_tpu_torch.kernels.stencil2d import half_planes_2d
    from remo3d_tpu_torch.ops.assembly2d import element_matrices_2d, fold_to_stencil

    rng = np.random.default_rng(17)
    nz, nr = 41, 23
    z = np.cumsum(rng.uniform(0.01, 1.0, nz))
    r = np.concatenate([[0.0], np.cumsum(rng.uniform(0.005, 0.8, nr - 1))])
    coords = np.stack(np.meshgrid(z, r, indexing="ij"), axis=-1)
    coords[1:-1, 1:-1] += rng.uniform(-0.2, 0.2, (nz - 2, nr - 2, 2)) * np.minimum(
        np.diff(z).min(), np.diff(r).min())
    sigma = 10.0 ** rng.uniform(-2, 2, (2, nz - 1, nr - 1))
    coords = np.broadcast_to(coords, (2, nz, nr, 2))
    C = fold_to_stencil(element_matrices_2d(torch.tensor(coords, dtype=torch.float32),
                                            torch.tensor(sigma, dtype=torch.float32)), nz, nr)
    assert C.dtype == torch.float32
    row_sum = C.double().sum(dim=(-2, -1))
    ulp = torch.finfo(torch.float32).eps * C[..., 1, 1].double().abs()
    assert bool((row_sum.abs() <= ulp).all()), float((row_sum.abs() / ulp).max())
    np.testing.assert_array_equal(half_planes_2d(C)[:, 0].numpy(), row_sum.float().numpy())


def chunk_diagnosis():
    """The decomposition of ``--chunk`` (module docstring)."""
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_enable_x64", True)
    import remo3d_tpu.ops.assembly2d as JA
    import remo3d_tpu.parallel.runtime as JR
    import remo3d_tpu_torch.ops.assembly2d as TA
    import remo3d_tpu_torch.parallel.runtime as TR
    from remo3d_tpu.ops.block_direct import block_thomas_apply
    from remo3d_tpu.ops.cg import pcg as jpcg
    from remo3d_tpu.ops.stencil import stencil_apply as jsa
    from remo3d_tpu_torch.meshing.carve import carve_local_model
    from remo3d_tpu_torch.meshing.native import build_grid2d_native
    from remo3d_tpu_torch.ops.cg import pcg as tpcg
    from remo3d_tpu_torch.planner import plan_tasks
    from remo3d_tpu_torch.tools import parse_tools

    tools, sec = parse_tools(EXAMPLE01_TOOLS, True)
    task = min(plan_tasks(tools, sec, DEPTHS, 5)[1], key=lambda t: abs(t.center_depth - 7.4))
    lm = carve_local_model(FORMATION, BOREHOLE[:, :2], 1.0, task.center_depth, 50.0,
                           active_geometry_window=0.999)
    sources = np.unique(np.concatenate([s.source_positions for s in task.solves]))
    g = build_grid2d_native(TSpec(), 50.0, lm, task.electrode_positions, sources)
    S = len(task.solves)
    src_i, src_fac = np.zeros((1, S, 2), np.int64), np.zeros((1, S, 2))
    for si, s in enumerate(task.solves):
        for k, (pos, fac) in enumerate(zip(s.source_positions, s.source_terms)):
            src_i[0, si, k], src_fac[0, si, k] = g.axis_node_index(pos), fac
    arrays = [g.coords[None], g.sigma_cells[None], g.free_mask[None], src_i, src_fac]

    def port_args(dt):
        return [torch.from_numpy(a.astype(dt) if a.dtype.kind == "f" else a) for a in arrays]

    def readouts(u):
        out = []
        for si, s in enumerate(task.solves):
            for ro in s.readouts:
                p = [u[0, si, g.axis_node_index(z)] for z in ro.measuring_positions]
                out.append(abs(ro.geometric_factor * (p[1] - p[0] if len(p) == 2 else p[0])))
        return np.array(out)

    def exact(C, rhs):  # a float32 system solved in float64
        C = torch.as_tensor(np.asarray(C, np.float64))
        x, _ = tpcg(C, torch.as_tensor(np.asarray(rhs, np.float64)), tol=1e-13, maxiter=5000,
                    M_inv=TR._factor2_direct(C, schedule="scan"))
        return x.numpy()

    def port_system(args):
        coords, sigma, free, si, sf = args
        C_raw = TA.fold_to_stencil(TA.element_matrices_2d(coords, sigma), *coords.shape[1:3])
        rhs, g_lift, u_s = TR._build_rhs2_subtract(coords, sigma, free, si, sf, C_raw)
        return TA.apply_dirichlet(C_raw, free), rhs, (g_lift + u_s).double().numpy()

    coords, sigma, free, si, sf = [jnp.asarray(a.astype(np.float32) if a.dtype.kind == "f" else a)
                                   for a in arrays]
    C_raw_j, C_j = JR._assemble2(coords, sigma, free)
    z_src = jnp.take_along_axis(coords[:, :, 0, 0][:, None, :], si, axis=-1)
    u_s = JA.fundamental_potential_2d(coords, sigma[:, 0, 0], z_src, sf)
    g_lift = jnp.where(free[:, None], 0.0, -u_s)
    rhs_j = jnp.where(free[:, None], JA.singularity_rhs_2d(coords, sigma, sigma[:, 0, 0], z_src, sf)
                      - jsa(C_raw_j, g_lift), 0.0)
    G = JR._factor2_direct(C_j, schedule="scan", passes=None)
    w_j, _ = jpcg(C_j, rhs_j, M_inv=lambda r: block_thomas_apply(G, C_j, r), tol=3e-7, maxiter=1000)
    off_j = np.asarray(g_lift + u_s, np.float64)

    truth = readouts(TR._solve_chunk_direct(*port_args(np.float64), tol=1e-10, maxiter=1000,
                                            schedule="scan")[0].numpy())
    C_t, rhs_t, off_t = port_system(port_args(np.float32))
    rows = {
        "port solve (half-storage matvec, difference form)": TR._solve_chunk_direct(
            *port_args(np.float32), tol=3e-7, maxiter=1000, schedule="scan")[0].double().numpy(),
        "port solve, full 9-point matvec (diagonal form)": TR._solve_chunk_direct(
            *port_args(np.float32), tol=3e-7, maxiter=1000, schedule="scan",
            use_kernel=False)[0].double().numpy(),
        "JAX solve": (np.asarray(w_j, np.float64) + off_j)[..., 0],
        "port float32 system, exact solve": (exact(C_t, rhs_t) + off_t)[..., 0],
        "JAX float32 system, exact solve": (exact(C_j, rhs_j) + off_j)[..., 0],
    }
    print(f"batch at {task.center_depth} m, {S} solves, {len(truth)} readouts, 761x161")
    for name, u in rows.items():
        e = readouts(u) / truth - 1
        print(f"{name}: readout error max {np.abs(e).max():.3e}, rms {rms(e):.3e}")


if __name__ == "__main__" and sys.argv[1:] == ["--chunk"]:
    chunk_diagnosis()
elif __name__ == "__main__":
    t0 = time.time()
    s, f64_rel = spreads(DEPTHS)
    print(f"761x161, direct scan, {len(DEPTHS)} depths {DEPTHS[0]:g}..{DEPTHS[-1]:g} m, "
          f"{time.time() - t0:.0f} s; float64 logs port vs jax {f64_rel:.3e}")
    for package, r in s.items():
        print(f"{package}: spread max {r.max():.3e}, rms {rms(r):.3e}; per tool " + ", ".join(
            f"{t} {r[:, i].max():.2e} (at {DEPTHS[r[:, i].argmax()]:g} m)"
            for i, t in enumerate(EXAMPLE01_TOOLS)))
    print(f"port - jax per readout: max {np.abs(s['port'] - s['jax']).max():.3e}")
