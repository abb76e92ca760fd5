# -*- coding: utf-8 -*-
"""The port's native mesher (``remo3d_tpu_torch/meshing/native.py``): its C++
builders (``native/grid2d.cpp``, ``csrc/grid3d_native.cpp``) against the port's
numpy builders, with the JAX package's limits (tests/test_grid.py: coordinates
within 1e-10, masks and 2D conductivities equal, 3D conductivities within 1e-9
relative); bitwise against ``remo3d_tpu.meshing.native`` on the same inputs;
the thin-annulus grids (``GridSpec3D.fz_h_radial``) against numpy too; and the
executor's choice of builder. The 3D ``Model`` log with native meshing on both
sides is in tests/test_torch_model3d.py."""

import dataclasses

import numpy as np
import pytest
import torch

import remo3d_tpu.meshing.native as jnative
import remo3d_tpu_torch.meshing.native as tnative
from remo3d_tpu.meshing.grid2d import GridSpec2D as JSpec2
from remo3d_tpu.meshing.grid3d import GridSpec3D as JSpec3
from remo3d_tpu_torch.meshing.carve import carve_local_model
from remo3d_tpu_torch.meshing.grid2d import GridSpec2D, build_grid2d
from remo3d_tpu_torch.meshing.grid3d import GridSpec3D, build_grid3d
from remo3d_tpu_torch.parallel import runtime

torch.set_num_threads(2)

FORMATION = np.array([
    [-100.0, -1.0, np.nan, np.nan, 10.0],
    [-1.0, 1.0, 0.3, 4.0, 20.0],
    [1.0, 100.0, np.nan, np.nan, 8.0],
])
ELECTRODES = np.array([-2.5, -2.0, 0.0, 0.4])
SOURCES = np.array([-0.1, 0.0, 0.1])
SPEC2 = dict(nz=97, nr=33, n_wall_cells=4, n_blend_cells=2)
SPEC3 = dict(nz=97, np_=9, nr=33, n_wall_cells=4, n_blend_cells=2)
# Invaded rows for the thin-annulus grids: 0.2 m lies within
# THIN_ANNULUS_MIN_CELLS * h_min_radial (0.12 m) of the 0.12 m wall, 0.5 m
# does not.
THIN_ROW = [-1.0, 0.0, 0.2, 4.0, 20.0]
THICK_ROW = [0.0, 1.0, 0.5, 5.0, 30.0]
BLENDS = ["arithmetic", "centroid", "harmonic", "mixed"]

pytestmark = pytest.mark.skipif(not tnative.native_available(), reason="no g++ to build the native mesher")


def local_model(dip_deg=0.0, mud=1.1):
    borehole = np.array([[-100.0, 0.12, mud], [100.0, 0.12, mud]])
    return carve_local_model(FORMATION, borehole, mud, 0.0, 50.0, dip_rad=np.deg2rad(dip_deg))


def test_library_is_built_in_the_package():
    """The library lies in the port's own build directory under a name keyed
    on the sources, never in the JAX loader's native/build/."""
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert path.name.startswith("libremo3d_grid_") and tnative.load_error() is None


def test_native_grid2d_matches_numpy():
    lm = local_model()
    g_py = build_grid2d(GridSpec2D(**SPEC2), 50.0, lm, ELECTRODES, SOURCES)
    g_c = tnative.build_grid2d_native(GridSpec2D(**SPEC2), 50.0, lm, ELECTRODES, SOURCES)
    assert np.allclose(g_py.z_axis, g_c.z_axis, atol=1e-10)
    assert np.allclose(g_py.coords, g_c.coords, atol=1e-10)
    assert np.array_equal(g_py.sigma_cells, g_c.sigma_cells)
    assert np.array_equal(g_py.free_mask, g_c.free_mask)
    assert g_py.axis_node_index(0.4) == g_c.axis_node_index(0.4)


@pytest.mark.parametrize("blend", BLENDS)
@pytest.mark.parametrize("dip_deg", [0, 30, 60])
def test_native_grid3d_matches_numpy(dip_deg, blend):
    lm = local_model(dip_deg)
    spec = GridSpec3D(**SPEC3, sigma_blend=blend)
    dip = np.deg2rad(dip_deg)
    g_py = build_grid3d(spec, 50.0, lm, dip, ELECTRODES, SOURCES)
    g_c = tnative.build_grid3d_native(spec, 50.0, lm, dip, ELECTRODES, SOURCES)
    assert np.allclose(g_py.z_axis, g_c.z_axis, atol=1e-10)
    assert np.allclose(g_py.coords, g_c.coords, atol=1e-10)
    assert np.allclose(g_py.sigma_cells, g_c.sigma_cells, rtol=1e-9, atol=0)
    assert np.array_equal(g_py.free_mask, g_c.free_mask)


@pytest.mark.parametrize("dim", ["2D", "3D dip 30", "3D dip 60 mixed"])
def test_native_grids_bitwise_equal_jax(dim):
    """The port's builds give the JAX loader's grids bit for bit: the shared
    2D source, and the port's 3D source without ``fz_h_radial`` against
    ``native/grid3d.cpp``."""
    if dim == "2D":
        lm = local_model()
        t = tnative.build_grid2d_native(GridSpec2D(**SPEC2), 50.0, lm, ELECTRODES, SOURCES)
        j = jnative.build_grid2d_native(JSpec2(**SPEC2), 50.0, lm, ELECTRODES, SOURCES)
    else:
        dip_deg = 30 if "30" in dim else 60
        blend = "mixed" if "mixed" in dim else "arithmetic"
        lm = local_model(dip_deg)
        dip = np.deg2rad(dip_deg)
        t = tnative.build_grid3d_native(GridSpec3D(**SPEC3, sigma_blend=blend), 50.0, lm, dip,
                                        ELECTRODES, SOURCES)
        j = jnative.build_grid3d_native(JSpec3(**SPEC3, sigma_blend=blend), 50.0, lm, dip,
                                        ELECTRODES, SOURCES)
    for field in ("z_axis", "coords", "sigma_cells", "free_mask"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=field)


THIN_CASES = [(dip, blend, anchors, SPEC3) for dip in (1e-3, 30, 60) for blend in BLENDS
              for anchors in ("thin", "thin and thick")] + [
    (60, "arithmetic", "thin and thick", dict(nz=257, np_=25, nr=65))]


@pytest.mark.parametrize("dip_deg,blend,anchors,shape", THIN_CASES)
def test_native_thin_annulus_grid3d_matches_numpy(dip_deg, blend, anchors, shape):
    """A spec with the thin-annulus anchor spacing is built natively (the
    ``build_grid3d_native_fz`` symbol) to the grid of numpy's ``build_grid3d``: thin
    invasion radii anchored at ``fz_h_radial``, the others at
    ``h_min_radial``; the last case is bm2_dip60's 257x25x65 high-dip spec."""
    rows = [THIN_ROW, THICK_ROW] if anchors == "thin and thick" else [
        THIN_ROW, THICK_ROW[:2] + [np.nan, np.nan, 30.0]]
    formation = np.array([[-100.0, -1.0, np.nan, np.nan, 10.0], *rows,
                          [1.0, 100.0, np.nan, np.nan, 8.0]])
    borehole = np.array([[-100.0, 0.12], [100.0, 0.12]])
    dip = np.deg2rad(dip_deg)
    lm = carve_local_model(formation, borehole, 1.1, 0.0, 50.0, dip_rad=dip)
    assert lm.invasion_radii.size == len(anchors.split(" and "))
    spec = GridSpec3D(**shape, sigma_blend=blend, fz_h_radial=0.025)
    g_c = tnative.build_grid3d_native(spec, 50.0, lm, dip, ELECTRODES, SOURCES)
    g_py = build_grid3d(spec, 50.0, lm, dip, ELECTRODES, SOURCES)
    g_plain = build_grid3d(dataclasses.replace(spec, fz_h_radial=None), 50.0, lm, dip,
                           ELECTRODES, SOURCES)
    assert not np.allclose(g_py.coords, g_plain.coords)  # the thin anchor moved the stations
    assert np.allclose(g_py.z_axis, g_c.z_axis, atol=1e-10)
    assert np.allclose(g_py.coords, g_c.coords, atol=1e-10)
    assert np.allclose(g_py.sigma_cells, g_c.sigma_cells, rtol=1e-9, atol=0)
    assert np.array_equal(g_py.free_mask, g_c.free_mask)


@pytest.mark.parametrize("dip,overrides,mesher", [
    (0.5, {}, "native"),
    (0.5, {"use_native_mesher": False}, "numpy"),
    (0.5, {"spec3d": GridSpec3D(**SPEC3, fz_h_radial=0.0125)}, "native"),
    (0.0, {"device_meshing": False}, "native"),
    (0.0, {"device_meshing": False, "use_native_mesher": False}, "numpy"),
    (0.0, {"device_meshing": True}, "device"),
])
def test_executor_mesher_choice(dip, overrides, mesher):
    """Host grids go native by default; device meshing is unchanged; the
    builder that ran is reported. Without the library the executor warns once
    and meshes with numpy."""
    ex = runtime.Executor(runtime.ExecutorConfig(device="cpu", **overrides))
    ex.prepare_batches([], FORMATION, np.array([[-100.0, 0.12], [100.0, 0.12]]), np.ones(1),
                       50.0, dip, 0.99)
    assert ex.mesher == mesher


def test_missing_toolchain_warns_once(monkeypatch):
    monkeypatch.setattr(runtime, "native_available", lambda: False)
    monkeypatch.setattr(runtime, "_numpy_fallback_warned", False)
    args = ([], FORMATION, np.array([[-100.0, 0.12], [100.0, 0.12]]), np.ones(1), 50.0, 0.5, 0.99)
    ex = runtime.Executor(runtime.ExecutorConfig(device="cpu"))
    with pytest.warns(RuntimeWarning, match="meshing with numpy"):
        ex.prepare_batches(*args)
    assert ex.mesher == "numpy"
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ex.prepare_batches(*args)  # once per process
