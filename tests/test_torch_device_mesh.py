# -*- coding: utf-8 -*-
"""On-device meshing: the port's ``device_mesh_2d`` against the JAX package's
on the same staged profiles (coords rtol 1e-6, conductivities exact), including
a formation of more than 48 carved layers so the layer-table pad bucket
(multiples of 16, floor 48) is exercised, and the port's device-meshed log
against its host-meshed log."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remo3d_tpu.meshing import carve as jcarve
from remo3d_tpu.meshing import device_mesh as jdm
from remo3d_tpu.meshing import grid2d as jgrid
from remo3d_tpu_torch import Model
from remo3d_tpu_torch.meshing.device_mesh import device_mesh_2d
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D

torch.set_num_threads(2)
CPU = jax.devices("cpu")[0]
SPEC = jgrid.GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2)


def _thin_beds():
    """60 alternating 0.25 m beds between infinite shoulders, some invaded."""
    edges = np.arange(-5.0, 10.0 + 0.25, 0.25)
    n = edges.size - 1
    rho = np.where(np.arange(n) % 2 == 0, 2.0, 20.0)
    fz_r = np.where(np.arange(n) % 3 == 0, 0.3, np.nan)
    fz_rho = np.where(np.isnan(fz_r), np.nan, 5.0)
    formation = np.column_stack([edges[:-1], edges[1:], fz_r, fz_rho, rho])
    formation[0, 0] = -1000.0
    formation[-1, 1] = 1000.0
    return formation


FORMATIONS = {
    "invaded_3_layers": np.array([
        [-100.0, -1.0, np.nan, np.nan, 10.0],
        [-1.0, 1.0, 0.3, 4.0, 20.0],
        [1.0, 100.0, np.nan, np.nan, 8.0],
    ]),
    "thin_beds_60_layers": _thin_beds(),
}


def _staged_profiles(formation, centers):
    """Light grids of a few batch centres, staged as the executor stages them."""
    borehole = np.array([[-1000.0, 0.1], [0.0, 0.14], [1000.0, 0.1]])
    grids = []
    for c in centers:
        lm = jcarve.carve_local_model(formation, borehole, 0.8, c, 50.0, active_geometry_window=0.999)
        grids.append(jgrid.build_grid2d_light(
            SPEC, 50.0, lm, np.array([-2.0, -0.5, 0.0, 1.0]), np.array([0.0])))
    L = max(g.bottoms.size for g in grids)
    lmax = max(48, -(-L // 16) * 16)
    B = len(grids)
    f32 = np.float32
    arrays = [
        np.stack([g.z_axis for g in grids]).astype(f32),
        np.stack([g.wall_of_z for g in grids]).astype(f32),
        np.stack([g.far for g in grids]).astype(f32),
        np.array([g.r_detach for g in grids], dtype=f32),
        np.full((B, lmax), np.inf, dtype=f32),
        np.full((B, lmax), np.nan, dtype=f32),
        np.full((B, lmax), np.nan, dtype=f32),
        np.ones((B, lmax), dtype=f32),
        np.array([g.bottoms.size for g in grids], dtype=np.int32),
        np.array([g.mud_sigma for g in grids], dtype=f32),
    ]
    for bi, g in enumerate(grids):
        n = g.bottoms.size
        arrays[4][bi, :n] = g.bottoms
        arrays[5][bi, :n] = g.fz_radius
        arrays[6][bi, :n] = g.sigma_fz
        arrays[7][bi, :n] = g.sigma_uz
    return arrays, L, lmax


@pytest.mark.parametrize("name", sorted(FORMATIONS))
def test_device_mesh_matches_jax(name):
    arrays, n_layers, lmax = _staged_profiles(FORMATIONS[name], [0.0, 2.35, 7.1])
    if name.startswith("thin"):
        assert n_layers > 48 and lmax == 64
    kw = dict(nz=SPEC.nz, nr=SPEC.nr, n_wall_cells=SPEC.n_wall_cells,
              n_blend_cells=SPEC.n_blend_cells, blend_m0=SPEC.blend_m0)
    with jax.default_device(CPU):
        c_j, s_j, f_j = jdm.device_mesh_2d(*[jnp.asarray(a) for a in arrays], np.float32(50.0), **kw)
    tensors = [torch.as_tensor(a) for a in arrays]
    tensors[8] = tensors[8].long()
    c_t, s_t, f_t = device_mesh_2d(*tensors, 50.0, **kw)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6, atol=1e-6 * 50.0)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert s_t.dtype == torch.float32 and f_t.dtype == torch.bool


def test_device_meshed_log_matches_host_meshed_log():
    """The executor's device-meshing staging (per-run pad bucket, 64 entries
    here) reproduces the host-meshed physics to float32 mesh noise (the JAX
    package's gate for the same pair: 5e-4)."""
    formation = FORMATIONS["thin_beds_60_layers"]
    borehole = np.array([[-1000.0, 0.1, 0.5], [1000.0, 0.1, 0.5]])

    def run(device_meshing):
        m = Model.compute_synthetic_logs(
            ["A2.0M0.5N", "B5.7A0.4M"], np.array([4.9, 5.1]), formation, borehole,
            borehole_geometry_type="radius", device="cpu", verbose=False,
            grid_spec=GridSpec2D(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2),
            executor_overrides={"device_meshing": device_meshing, "chunk_size": 2},
        )
        assert m.last_report["n_failed_solves"] == 0
        return np.concatenate([v[:, 1] for v in m.logs.values()])

    dev, host = run(True), run(False)
    assert np.isfinite(dev).all()
    assert np.abs(dev / host - 1).max() < 5e-4, (dev, host)
