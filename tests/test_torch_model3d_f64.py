# -*- coding: utf-8 -*-
"""The 3D slice as a whole in float64: the port's ``Model`` against
``remo3d_tpu.Model`` on the CPU with dtype="float64" and tol=1e-12 on both
sides (same problem as tests/test_torch_model3d.py); readouts within 1e-9.

The JAX package's float64 mode turns on ``jax_enable_x64`` for the whole
process, so this case has a file of its own and restores the flag afterwards.
"""

import jax
import numpy as np

from tests.test_torch_model3d import TOOLS, run_both


def test_float64_dip30_log_matches_jax():
    before = jax.config.jax_enable_x64
    try:
        port, ref = run_both("float64", 1e-12)
    finally:
        jax.config.update("jax_enable_x64", before)
    for t in TOOLS:
        assert port.logs[t].dtype == np.float64
        np.testing.assert_allclose(port.logs[t][:, 1], ref.logs[t][:, 1], rtol=1e-9)
