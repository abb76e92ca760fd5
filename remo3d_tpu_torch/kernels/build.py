# -*- coding: utf-8 -*-
"""Build the package's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own nvcc for ``sm_90a``, all of them
started together, and the objects are linked into ONE shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). ptxas reports
each kernel's registers, spills and static shared memory (``-Xptxas -v``); the
report is kept beside the library (:func:`build_log_path`).
The library lives in ``remo3d_tpu_torch/_build/`` under a name keyed on a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged one is
loaded as it is. Nothing outside the package's own sources goes into the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# C entry points: name -> argtypes. Every pointer and the stream are c_void_p
# (ctypes would otherwise pass a 64-bit address as a 32-bit int), sizes c_int.
_P, _I = ctypes.c_void_p, ctypes.c_int
_INFO = ctypes.POINTER(ctypes.c_int * 6)
_PLAN = ctypes.POINTER(ctypes.c_int)  # K3's tile plan (kernels/pcr_lines.py PLAN_FIELDS)
ENTRY_POINTS = {
    # (C, u, y, B, S, NZ, NR, tile_rows, stream)
    "stencil2d_half_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "stencil2d_half_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (C, u, y, B, S, NZ, NP, NR, pole, tile_rows, stream)
    "stencil3d_half_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "stencil3d_half_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # (F, b, x, B, S, outer, n, inner, L, plan, stream): K3 on lines (outer,
    # n, inner) with the wrapper's tile plan
    "pcr_lines_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _PLAN, _P],
    "pcr_lines_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _PLAN, _P],
    # (F, b, x, base, scale, B, S, outer, n, inner, L, plan, stream): K3 with
    # the step epilogue, x = base + scale T^-1 b (base may be null or x)
    "pcr_lines_step_f32": [_P, _P, _P, _P, ctypes.c_double, _I, _I, _I, _I, _I, _I, _PLAN, _P],
    "pcr_lines_step_f64": [_P, _P, _P, _P, ctypes.c_double, _I, _I, _I, _I, _I, _I, _PLAN, _P],
    # (S, NR, tile_rows, out) / (S, NP, NR, tile_rows, out) / (B, S, outer,
    # n, inner, L, plan, out): what a launch would use, see kernel_info
    "stencil2d_half_info_f32": [_I, _I, _I, _INFO],
    "stencil2d_half_info_f64": [_I, _I, _I, _INFO],
    "stencil3d_half_info_f32": [_I, _I, _I, _I, _INFO],
    "stencil3d_half_info_f64": [_I, _I, _I, _I, _INFO],
    "pcr_lines_info_f32": [_I, _I, _I, _I, _I, _I, _PLAN, _INFO],
    "pcr_lines_info_f64": [_I, _I, _I, _I, _I, _I, _PLAN, _INFO],
    "pcr_lines_step_info_f32": [_I, _I, _I, _I, _I, _I, _PLAN, _INFO],
    "pcr_lines_step_info_f64": [_I, _I, _I, _I, _I, _I, _PLAN, _INFO],
}
INFO_FIELDS = ("registers", "spill_bytes", "smem_bytes", "tile_rows", "solves_per_group",
               "blocks_per_sm")

_library = None


class BuildError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise BuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def library_path(defines: tuple[str, ...] = ()) -> Path:
    """Where the library for the current sources, flags and ``-D`` defines lives."""
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libremo3d_kernels_{h.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    """ptxas' report (registers, spills) of the build of :func:`library_path`."""
    return library_path().with_suffix(".ptxas.txt")


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; raises BuildError."""
    global _library
    if _library is None:
        _library = build_library()
    return _library


def build_library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile (if needed) and load a library built with ``-D`` ``defines``: the
    package's own with none, a probe build (see ``csrc/stencil3d.cu``) else."""
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    out = library_path(defines)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        # Build in a private directory, then rename: concurrent builders never
        # load a half-written library.
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objects = [os.path.join(tmp, f"{src.stem}.o") for src in _sources()]
            compiles = [
                [nvcc, *flags, "-c", str(src), "-o", obj]
                for src, obj in zip(_sources(), objects)
            ]
            procs = [
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for cmd in compiles
            ]
            results = [(cmd, proc, proc.communicate()) for cmd, proc in zip(compiles, procs)]
            so = os.path.join(tmp, out.name)
            link = [nvcc, *flags, "-shared", "-o", so, *objects]
            for cmd, proc, (_, err) in results:
                if proc.returncode != 0:
                    raise BuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise BuildError(f"nvcc failed ({proc.returncode}): {' '.join(link)}\n{proc.stderr}")
            out.with_suffix(".ptxas.txt").write_text("".join(err for _, _, (_, err) in results))
            os.replace(so, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise BuildError(f"cannot load {out}: {e}") from e
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def kernel_info(entry: str, *sizes: int) -> dict:
    """What a launch of ``entry`` (an ``*_info_*`` entry point) at ``sizes``
    would use: registers and spill bytes per thread, dynamic shared memory per
    block, tile height, solves per group and resident blocks per SM, as the
    CUDA runtime reports them for the built kernel."""
    out = (ctypes.c_int * 6)()
    err = getattr(load_library(), entry)(*sizes, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{entry}{sizes} failed: CUDA error {err}")
    return dict(zip(INFO_FIELDS, out))
