# -*- coding: utf-8 -*-
"""Semi-analytic point-source potential in a 1D layered full space (no borehole).

Independent accuracy oracle for the FEM solvers (test pyramid per SURVEY §4:
solver tests vs analytic solutions). A unit DC current source on the z-axis of a
stack of horizontal layers; the potential is evaluated on the axis via the
classical Hankel/propagator formulation:

    u(z) = I/(4*pi*sigma_s*|z - z_s|)  +  ∫_0^∞ Ψ(λ, z) dλ

with the secondary kernel Ψ expanded per layer as decaying exponentials
``A_i e^{-λ(z - top_i)} + B_i e^{+λ(z - bot_i)}`` and coefficients from the
interface continuity of potential and normal current. Because every reflection
path is at least |z - z_s| long, the kernel decays like ``exp(-λ|z - z_s|)`` and
a modest log-spaced quadrature is exact to ~1e-6 for receiver offsets of meters.

A numpy copy of ``remo3d_tpu.utils.layered_oracle`` (the JAX package cannot be
imported without JAX); tests/test_torch_oracle.py pins the two bit-equal.
"""

from __future__ import annotations

import numpy as np

# np.trapezoid is NumPy >= 2.0; keep 1.x environments working (np.trapz was
# removed in 2.x, so probe rather than pin).
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class LayeredOracle:
    """Precomputes the interface system for a layer stack; solves many sources
    with ONE batched multi-RHS linear solve (the matrix is source-independent)."""

    def __init__(
        self,
        boundaries: np.ndarray,
        sigmas: np.ndarray,
        n_lambda: int = 1200,
        lam_min: float = 1e-4,
        lam_max: float = 60.0,
    ):
        self.boundaries = np.asarray(boundaries, dtype=float)
        self.sigmas = np.asarray(sigmas, dtype=float)
        n_layers = self.sigmas.size
        assert self.boundaries.size == n_layers - 1 and n_layers >= 2
        self.n_layers = n_layers
        self.lam = np.geomspace(lam_min, lam_max, n_lambda)
        lam = self.lam

        b = self.boundaries
        self.tops = np.concatenate([[b[0]], b])  # layer i top (valid i>=1)
        self.bots = np.concatenate([b, [b[-1]]])  # layer i bottom (valid i<N-1)
        h = np.where(
            np.arange(n_layers) == 0,
            np.inf,
            np.where(np.arange(n_layers) == n_layers - 1, np.inf, self.bots - self.tops),
        )

        # Unknowns x = [B_0, A_1, B_1, ..., A_{N-2}, B_{N-2}, A_{N-1}].
        n_unk = 2 * (n_layers - 1)
        self.n_unk = n_unk
        M = np.zeros((n_lambda, n_unk, n_unk))
        e_h = np.exp(-lam[:, None] * np.where(np.isfinite(h), h, np.inf)[None, :])
        sig = self.sigmas
        for k in range(n_layers - 1):
            rowP, rowJ = 2 * k, 2 * k + 1
            if k >= 1:
                M[:, rowP, self._a(k)] += e_h[:, k]
                M[:, rowJ, self._a(k)] += -lam * sig[k] * e_h[:, k]
            M[:, rowP, self._b(k)] += 1.0
            M[:, rowJ, self._b(k)] += lam * sig[k]
            if k + 1 <= n_layers - 2:
                M[:, rowP, self._b(k + 1)] += -e_h[:, k + 1]
                M[:, rowJ, self._b(k + 1)] += -lam * sig[k + 1] * e_h[:, k + 1]
            M[:, rowP, self._a(k + 1)] += -1.0
            M[:, rowJ, self._a(k + 1)] += lam * sig[k + 1]
        # Factor once: the matrix is source-independent, so every subsequent
        # source costs one batched matmul instead of a dense solve.
        self._Minv = np.linalg.inv(M)

    @staticmethod
    def _a(i):  # A_i exists for i >= 1
        return 2 * i - 1

    @staticmethod
    def _b(i):  # B_i exists for i <= N-2
        return 2 * i

    def potentials(
        self,
        z_sources: np.ndarray,
        z_receivers: np.ndarray,
        current=1.0,
        r_receivers: np.ndarray | float | None = None,
    ):
        """u[si, rj] for every (source, receiver) pair — one batched solve.

        ``r_receivers`` (optional): horizontal (cylindrical-radial) distance of
        each receiver from its source's vertical axis; scalar, (n_rec,), or
        (n_src, n_rec). Off-axis evaluation inserts the Bessel factor
        ``J0(lambda*r)`` into the Hankel kernel — this is what lets a rigidly
        rotated (dipping-layer) problem be evaluated exactly: rotate the
        electrode line into the layer frame and the receivers land off-axis.
        """
        z_sources = np.atleast_1d(np.asarray(z_sources, dtype=float))
        z_receivers = np.atleast_1d(np.asarray(z_receivers, dtype=float))
        lam = self.lam
        sig = self.sigmas
        b = self.boundaries
        n_src = z_sources.size
        if r_receivers is None:
            r_rec = np.zeros((n_src, z_receivers.size))
        else:
            r_rec = np.broadcast_to(
                np.asarray(r_receivers, dtype=float), (n_src, z_receivers.size)
            )

        s_idx = np.searchsorted(b, z_sources)
        C = current / (4.0 * np.pi * sig[s_idx])  # (n_src,)

        rhs = np.zeros((lam.size, self.n_unk, n_src))
        for k in range(self.n_layers - 1):
            zk = b[k]
            dphi = (
                C[None, :]
                * (-lam[:, None])
                * np.sign(zk - z_sources)[None, :]
                * np.exp(-lam[:, None] * np.abs(zk - z_sources)[None, :])
            )
            rhs[:, 2 * k + 1, :] = (sig[k + 1] - sig[k]) * dphi

        x = self._Minv @ rhs  # (n_lambda, n_unk, n_src)

        out = np.empty((n_src, z_receivers.size))
        on_axis = not np.any(r_rec)
        if not on_axis:
            from scipy.special import j0
        for j, zr in enumerate(z_receivers):
            i = int(np.searchsorted(b, zr))
            psi = np.zeros((lam.size, n_src))
            if i >= 1:
                psi += x[:, self._a(i), :] * np.exp(-lam * (zr - self.tops[i]))[:, None]
            if i <= self.n_layers - 2:
                psi += x[:, self._b(i), :] * np.exp(lam * (zr - self.bots[i]))[:, None]
            if on_axis:
                integral = _trapezoid(psi, lam, axis=0) + psi[0] * lam[0]
                out[:, j] = C / np.abs(zr - z_sources) + integral
            else:
                # J0(lam*r) per source column (r may differ across sources).
                bess = j0(lam[:, None] * r_rec[:, j][None, :])
                integral = _trapezoid(psi * bess, lam, axis=0) + (psi * bess)[0] * lam[0]
                dist = np.sqrt(r_rec[:, j] ** 2 + (zr - z_sources) ** 2)
                out[:, j] = C / dist + integral
        return out


def layered_axis_potential(
    boundaries: np.ndarray,
    sigmas: np.ndarray,
    z_src: float,
    z_receivers: np.ndarray,
    current: float = 1.0,
    n_lambda: int = 1200,
    lam_min: float = 1e-4,
    lam_max: float = 60.0,
) -> np.ndarray:
    """Potential on the axis for a point source at (0, z_src).

    boundaries: (N-1,) strictly increasing interface depths.
    sigmas: (N,) layer conductivities, top to bottom (layer i occupies
    (boundaries[i-1], boundaries[i])).
    """
    oracle = LayeredOracle(boundaries, sigmas, n_lambda, lam_min, lam_max)
    return oracle.potentials(np.array([z_src]), z_receivers, current)[0]


def layered_apparent_resistivity(
    boundaries, resistivities, tool_offsets, geometric_factor, z_tool
):
    """Apparent resistivity of a single-current-electrode tool in the layered
    medium: offsets = (z_src, z_M[, z_N]) relative to the tool position."""
    sig = 1.0 / np.asarray(resistivities, dtype=float)
    z_src = z_tool + tool_offsets[0]
    receivers = np.asarray(tool_offsets[1:], dtype=float) + z_tool
    u = layered_axis_potential(boundaries, sig, z_src, receivers)
    du = u[0] - u[1] if receivers.size == 2 else u[0]
    return abs(geometric_factor * du)
