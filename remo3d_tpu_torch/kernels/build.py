# -*- coding: utf-8 -*-
"""Build the package's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by nvcc for ``sm_90a`` into ONE shared
library with a plain C interface (no PyTorch headers, so a build takes seconds).
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# C entry points: name -> argtypes. Every pointer and the stream are c_void_p
# (ctypes would otherwise pass a 64-bit address as a 32-bit int), sizes c_int.
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {
    "stencil2d_half_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "stencil2d_half_f64": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_library = None


class BuildError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise BuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libremo3d_kernels_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; raises BuildError."""
    global _library
    if _library is not None:
        return _library
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build to a private name, then rename: concurrent builders never load
        # a half-written library.
        nvcc = _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise BuildError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise BuildError(f"cannot load {out}: {e}") from e
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _library = lib
    return lib
