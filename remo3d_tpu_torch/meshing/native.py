# -*- coding: utf-8 -*-
"""ctypes bindings of the port's native C++ grid builders: the repo's 2D
builder (``native/grid2d.cpp``, ``native/grid_common.h``) and the port's own 3D
builder (``csrc/grid3d_native.cpp``).

The counterpart of ``remo3d_tpu.meshing.native``. The sources under ``native/``
are shared with the JAX package and only read here. ``csrc/grid3d_native.cpp``
is ``native/grid3d.cpp`` with the thin-annulus anchors of
``GridSpec3D.fz_h_radial`` added, exported as ``build_grid3d_native_fz``
(``fz_h_radial`` NaN for none). g++ compiles them with the JAX loader's flags
(so both packages' native grids are bitwise equal where neither refines an
annulus) into a plain C shared library under ``remo3d_tpu_torch/_build/``,
named by a hash of the sources and flags. A build goes to a private name first
and is renamed into place, so two processes that build at once never load a
half-written library. The numpy builders (``grid2d.build_grid2d``,
``grid3d.build_grid3d``) are the reference specification; the executor falls
back to them, with a warning, when no toolchain is there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .carve import LocalModel
from .grid2d import Grid2D, GridSpec2D
from .grid3d import THIN_ANNULUS_MIN_CELLS, Grid3D, GridSpec3D

PACKAGE_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = PACKAGE_DIR.parent / "native"
SOURCES = [NATIVE_DIR / "grid2d.cpp", PACKAGE_DIR / "csrc" / "grid3d_native.cpp"]
HEADER = NATIVE_DIR / "grid_common.h"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_SIGMA_BLEND_CODES = {"centroid": 0, "arithmetic": 1, "harmonic": 2, "mixed": 3}

_lock = threading.Lock()
_lib = None
_lib_error: str | None = None


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in [*SOURCES, HEADER]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libremo3d_grid_{h.hexdigest()[:16]}.so"


def _build_and_load() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            so = os.path.join(tmp, out.name)
            subprocess.run(
                ["g++", *CXX_FLAGS, *map(str, SOURCES), "-o", so],
                check=True, capture_output=True,
            )
            os.replace(so, out)
    lib = ctypes.CDLL(str(out))
    lib.build_grid2d_native.restype = ctypes.c_int
    lib.build_grid3d_native_fz.restype = ctypes.c_int
    return lib


def _load():
    """The loaded library, or None when it cannot be built or loaded (the
    reason is kept in ``load_error()``)."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    with _lock:
        if _lib is None and _lib_error is None:
            try:
                _lib = _build_and_load()
            except (OSError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", b"") or b""
                _lib_error = f"{type(e).__name__}: {e} {detail.decode(errors='replace')}".strip()
    return _lib


def native_available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    """Why the library is unavailable (None while it is available or untried)."""
    return _lib_error


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _model_arrays(local_model: LocalModel, electrode_positions, source_positions):
    """The C ABI's contiguous float64 inputs: electrodes, sources, boundaries,
    bottoms, invasion radii (NaN markers kept), invaded and uninvaded
    conductivities, borehole z and r."""
    bh = local_model.borehole
    return [
        np.ascontiguousarray(np.asarray(electrode_positions, dtype=float)),
        np.ascontiguousarray(np.asarray(source_positions, dtype=float)),
        np.ascontiguousarray(local_model.boundaries),
        np.ascontiguousarray(local_model.bottoms),
        np.ascontiguousarray(local_model.fz_radius),
        np.ascontiguousarray(np.nan_to_num(local_model.sigma_fz, nan=0.0)),
        np.ascontiguousarray(local_model.sigma_uz),
        np.ascontiguousarray(bh[:, 0]),
        np.ascontiguousarray(bh[:, 1]),
    ]


def _model_args(arrays):
    electrodes, sources, boundaries, bottoms, fz, sfz, suz, bh_z, bh_r = arrays
    return [
        _dptr(electrodes), ctypes.c_int(electrodes.size),
        _dptr(sources), ctypes.c_int(sources.size),
        _dptr(boundaries), ctypes.c_int(boundaries.size),
        _dptr(bottoms), ctypes.c_int(bottoms.size),
        _dptr(fz), _dptr(sfz), _dptr(suz),
        _dptr(bh_z), _dptr(bh_r), ctypes.c_int(bh_z.size),
    ]


def _grading_args(spec) -> list:
    return [ctypes.c_double(getattr(spec, name)) for name in (
        "h_min_source", "slope_source", "h_min_electrode", "slope_electrode",
        "h_min_boundary", "slope_boundary", "h_max_axial_frac", "h_min_radial",
        "slope_radial", "h_max_radial_frac", "blend_m0",
    )]


def build_grid2d_native(
    spec: GridSpec2D,
    domain_radius: float,
    local_model: LocalModel,
    electrode_positions: np.ndarray,
    source_positions: np.ndarray,
) -> Grid2D:
    """Native counterpart of :func:`remo3d_tpu_torch.meshing.grid2d.build_grid2d`."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native grid builder unavailable: {_lib_error}")
    arrays = _model_arrays(local_model, electrode_positions, source_positions)
    coords = np.empty((spec.nz, spec.nr, 2), dtype=float)
    sigma = np.empty((spec.nz - 1, spec.nr - 1), dtype=float)
    z_axis = np.empty((spec.nz,), dtype=float)
    ret = lib.build_grid2d_native(
        ctypes.c_double(domain_radius),
        ctypes.c_int(spec.nz), ctypes.c_int(spec.nr),
        ctypes.c_int(spec.n_wall_cells), ctypes.c_int(spec.n_blend_cells),
        *_grading_args(spec),
        *_model_args(arrays),
        ctypes.c_double(local_model.mud_sigma),
        _dptr(coords), _dptr(sigma), _dptr(z_axis),
    )
    if ret != 0:
        raise RuntimeError(f"native grid builder failed with code {ret}")
    free_mask = np.ones((spec.nz, spec.nr), dtype=bool)
    free_mask[0, :] = False
    free_mask[-1, :] = False
    free_mask[:, -1] = False
    return Grid2D(spec=spec, z_axis=z_axis, coords=coords, sigma_cells=sigma,
                  free_mask=free_mask)


def build_grid3d_native(
    spec: GridSpec3D,
    domain_radius: float,
    local_model: LocalModel,
    dip_rad: float,
    electrode_positions: np.ndarray,
    source_positions: np.ndarray,
) -> Grid3D:
    """Native counterpart of :func:`remo3d_tpu_torch.meshing.grid3d.build_grid3d`,
    the thin-annulus anchors of ``spec.fz_h_radial`` included."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native grid builder unavailable: {_lib_error}")
    arrays = _model_arrays(local_model, electrode_positions, source_positions)
    coords = np.empty((spec.nz, spec.np_, spec.nr, 3), dtype=float)
    sigma = np.empty((spec.nz - 1, spec.np_ - 1, spec.nr - 1), dtype=float)
    z_axis = np.empty((spec.nz,), dtype=float)
    fz_h = np.nan if spec.fz_h_radial is None else spec.fz_h_radial
    ret = lib.build_grid3d_native_fz(
        ctypes.c_double(domain_radius),
        ctypes.c_int(spec.nz), ctypes.c_int(spec.np_), ctypes.c_int(spec.nr),
        ctypes.c_int(spec.n_wall_cells), ctypes.c_int(spec.n_blend_cells),
        *_grading_args(spec),
        ctypes.c_double(spec.shear_cap_frac),
        ctypes.c_double(float(np.tan(dip_rad))),
        ctypes.c_int(_SIGMA_BLEND_CODES[spec.sigma_blend]),
        ctypes.c_double(fz_h), ctypes.c_double(THIN_ANNULUS_MIN_CELLS),
        *_model_args(arrays),
        ctypes.c_double(local_model.mud_sigma),
        _dptr(coords), _dptr(sigma), _dptr(z_axis),
    )
    if ret != 0:
        raise RuntimeError(f"native grid builder failed with code {ret}")
    free_mask = np.ones((spec.nz, spec.np_, spec.nr), dtype=bool)
    free_mask[0] = False
    free_mask[-1] = False
    free_mask[:, :, -1] = False
    return Grid3D(spec=spec, z_axis=z_axis, coords=coords, sigma_cells=sigma,
                  free_mask=free_mask)
