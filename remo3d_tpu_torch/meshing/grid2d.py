# -*- coding: utf-8 -*-
"""Boundary-fitted structured grid for the 2D axisymmetric problem.

Replaces the reference's per-task unstructured tri meshes
(gmsh_functions.py:384-542, netgen_functions.py:120-335) with a fixed-topology
tensor-product quad grid in tool-centered coordinates:

* axial lines graded toward current electrodes (the reference grades mesh size as
  ``(x^2+(y+z_e)^2)/2 + 0.01`` near electrodes and ``x + 0.1`` radially,
  gmsh_functions.py:487-500; we use the same intent with a density-function grading)
  and snapped exactly to every electrode depth and layer boundary;
* radial stations wall-following inside the borehole (the caliper-varying wall is a
  grid line), blended to fixed vertical stations snapped to invasion radii, and
  geometrically graded to the far field;
* a "squircle" blend maps the outer part of the logical rectangle onto the EXACT
  circle of ``domain_radius`` so the homogeneous Dirichlet truncation boundary matches
  the reference's circular domain, while the near field stays rectangle-aligned and
  material-conforming.

The same topology (NZ x NR) is emitted for every batch, so every chunk of the log
has one tensor shape; only node positions and cell conductivities change.

A numpy copy of ``remo3d_tpu.meshing.grid2d`` (the JAX package cannot be
imported without JAX); tests/test_torch_host.py pins the two bit-equal.
``_graded_1d`` is written differently (its sample offsets built once per
``h_min``, the nearest anchor found by bisection) and gives bit-equal outputs.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .carve import LocalModel


@dataclasses.dataclass(frozen=True)
class GridSpec2D:
    """Static grid topology + grading parameters (compile-time constants)."""

    # Defaults tuned against the reference goldens (Example_01: max 0.066% /
    # mean 0.023% apparent-resistivity deviation with singularity subtraction).
    nz: int = 761  # axial node lines; nz-1 divisible by 8 for multigrid coarsening
    nr: int = 161  # radial node stations; nr-1 divisible by 8 for multigrid coarsening
    n_wall_cells: int = 8  # cells between axis and borehole wall
    n_blend_cells: int = 4  # cells between the wall and the first fixed station
    # Axial grading: h(z) = clip(h_min_src + slope_src*dist_to_source, ., h_max)
    h_min_source: float = 0.01
    slope_source: float = 0.6
    h_min_electrode: float = 0.02
    slope_electrode: float = 0.5
    h_min_boundary: float = 0.05
    slope_boundary: float = 1.0
    h_max_axial_frac: float = 0.12  # h_max = frac * domain_radius
    # Radial grading beyond the blend zone (the accuracy-critical budget: the
    # smooth correction field has its strongest variation at the borehole wall
    # and invasion/layer interfaces):
    h_min_radial: float = 0.008
    slope_radial: float = 0.12
    h_max_radial_frac: float = 0.12
    # Squircle blend: identity for m <= m0, exact circle at m == 1.
    blend_m0: float = 0.35


@dataclasses.dataclass
class Grid2D:
    """One batch's grid: physical coordinates + conductivities + boundary data."""

    spec: GridSpec2D
    z_axis: np.ndarray  # (NZ,) axial line positions BEFORE blending == axis values
    coords: np.ndarray  # (NZ, NR, 2) physical (z, r) node positions
    sigma_cells: np.ndarray  # (NZ-1, NR-1) cell conductivities
    free_mask: np.ndarray  # (NZ, NR) True on non-Dirichlet nodes
    # Differentiable-path provenance (remo3d_tpu.diff), None unless requested:
    # local layer index per cell (-1 = borehole mud column) and the invaded-
    # zone mask — together with LocalModel.global_rows/fz_promoted these map
    # every cell to one global formation parameter.
    region_layer: np.ndarray | None = None  # (NZ-1, NR-1) int32
    region_invaded: np.ndarray | None = None  # (NZ-1, NR-1) bool

    def axis_node_index(self, z: float, tol: float = 1e-3) -> int:
        """Index of the axial grid line carrying position ``z`` (snapped exactly)."""
        i = int(np.argmin(np.abs(self.z_axis - z)))
        if abs(self.z_axis[i] - z) > tol:
            raise ValueError(
                f"position {z} is not a grid line (nearest {self.z_axis[i]:.5f})"
            )
        return i


@functools.lru_cache(maxsize=64, typed=True)
def _anchor_offsets(h_min: float) -> np.ndarray:
    """The density samples around one anchor of ``_graded_1d``, as offsets from
    it: 48 geometric steps from ``h_min / 4`` to 2 on each side, and 0. Cached
    per ``h_min`` (read-only)."""
    offsets = np.concatenate(
        [-np.geomspace(h_min / 4, 2.0, 48)[::-1], [0.0], np.geomspace(h_min / 4, 2.0, 48)]
    )
    offsets.flags.writeable = False
    return offsets


def _graded_1d(
    lo: float,
    hi: float,
    n_lines: int,
    h_terms: list[tuple[np.ndarray, float, float]],
    h_max: float,
) -> np.ndarray:
    """Place ``n_lines`` points in [lo, hi] following a 1/h density.

    ``h_terms`` is a list of (centers, h_min, slope): each contributes a local target
    size ``h_min + slope * distance_to_nearest_center``; the effective size is the
    minimum over all terms, capped at ``h_max``. The point count is fixed, so the
    whole density is scaled to exactly fill the budget (finer everywhere when the
    budget allows).
    """
    samples = [np.linspace(lo, hi, 4001)]
    for centers, h_min, _ in h_terms:
        # Center by center, in the order the JAX package's loop appends them.
        centers = np.atleast_1d(centers)
        samples.append((centers[:, None] + _anchor_offsets(h_min)[None, :]).ravel())
    zz = np.unique(np.clip(np.concatenate(samples), lo, hi))

    h = np.full_like(zz, h_max)
    for centers, h_min, slope in h_terms:
        centers = np.sort(np.atleast_1d(centers))
        if centers.size == 0:
            continue
        # The nearest center is one of the two that bracket each sample: float
        # subtraction is monotone, so this is the minimum over all centers, bit
        # for bit.
        j = np.searchsorted(centers, zz)
        below = centers[np.maximum(j - 1, 0)]
        above = centers[np.minimum(j, centers.size - 1)]
        dist = np.minimum(np.abs(zz - below), np.abs(zz - above))
        h = np.minimum(h, h_min + slope * dist)
    density = 1.0 / h
    cum = np.concatenate([[0.0], np.cumsum(0.5 * (density[1:] + density[:-1]) * np.diff(zz))])
    # Fixed budget: rescale so the integral equals exactly n_lines - 1 cells.
    cum *= (n_lines - 1) / cum[-1]
    return np.interp(np.arange(n_lines, dtype=float), cum, zz)


def _snap(lines: np.ndarray, targets: np.ndarray, lock_ends: bool = True) -> np.ndarray:
    """Move grid lines so every target value is exactly a line; preserve ordering.

    Targets are assigned nearest lines greedily in ascending order with a strictly
    increasing index constraint; endpoints are never moved when ``lock_ends``.
    """
    lines = lines.copy()
    targets = np.sort(np.unique(np.asarray(targets, dtype=float)))
    if targets.size > 1:
        # Merge targets that only differ by float noise (e.g. a layer boundary at
        # center+0.1 vs an electrode rounded to 0.1): coincident targets would snap
        # two adjacent lines onto (nearly) the same position and produce degenerate
        # cells whose float32 Jacobians vanish.
        keep = np.concatenate([[True], np.diff(targets) > 1e-7])
        targets = targets[keep]
    lo_idx = 1 if lock_ends else 0
    hi_idx = lines.size - 2 if lock_ends else lines.size - 1
    targets = targets[(targets > lines[0]) & (targets < lines[-1])] if lock_ends else targets

    prev = lo_idx - 1
    for t_i, t in enumerate(targets):
        remaining = targets.size - t_i - 1
        idx = int(np.argmin(np.abs(lines - t)))
        idx = min(max(idx, prev + 1), hi_idx - remaining)
        if idx <= prev:
            raise ValueError("not enough grid lines to snap all targets")
        lines[idx] = t
        prev = idx
    lines = np.sort(lines)
    return lines


def _squircle_blend(z: np.ndarray, r: np.ndarray, radius: float, m0: float):
    """Map the logical rectangle [-R,R]x[0,R] onto the half-disc of radius R.

    Identity for L-inf radius m <= m0; the outer square rings morph smoothly onto
    circles, with the boundary ring mapped EXACTLY onto the circle. Rays from the
    origin are preserved, so the borehole axis (r=0) and equator are unmoved.
    """
    zn = z / radius
    rn = r / radius
    m = np.maximum(np.abs(zn), np.abs(rn))
    s = np.clip((m - m0) / (1.0 - m0), 0.0, 1.0)
    w = s * s * (3.0 - 2.0 * s)
    # Euclidean norm of the unit-square ring point along this direction:
    q = np.where(m > 0, np.hypot(zn, rn) / np.where(m > 0, m, 1.0), 1.0)
    f = (1.0 - w) + w / np.where(q > 0, q, 1.0)
    return z * f, r * f


def build_profiles_2d(
    spec: GridSpec2D,
    domain_radius: float,
    local_model: LocalModel,
    electrode_positions: np.ndarray,
    source_positions: np.ndarray,
):
    """The 1D phase of the grid build: graded/snapped axial lines, the
    caliper-following wall profile, the detach radius and the far radial
    stations. Everything downstream (node coordinates, conductivity sampling,
    squircle blend) is a closed-form function of these profiles — which is what
    lets the device-meshing path ship ~KB of profiles instead of ~MB of arrays
    per batch (meshing/device_mesh.py)."""
    R = float(domain_radius)
    electrodes = np.asarray(electrode_positions, dtype=float)
    sources = np.asarray(source_positions, dtype=float)

    # ---- Axial lines -------------------------------------------------------------
    boundaries = local_model.boundaries
    near_boundaries = boundaries[np.abs(boundaries) < 0.98 * R]
    h_max_z = spec.h_max_axial_frac * R
    z_lines = _graded_1d(
        -R,
        R,
        spec.nz,
        [
            (sources, spec.h_min_source, spec.slope_source),
            (electrodes, spec.h_min_electrode, spec.slope_electrode),
            (near_boundaries, spec.h_min_boundary, spec.slope_boundary),
        ],
        h_max_z,
    )
    snap_targets = np.concatenate([electrodes, near_boundaries])
    z_lines = _snap(z_lines, snap_targets)

    # ---- Radial stations ---------------------------------------------------------
    bh = local_model.borehole
    wall_of_z = np.interp(z_lines, bh[:, 0], bh[:, 1])  # constant extension at ends
    wall_max = float(np.max(bh[:, 1]))
    invasion = local_model.invasion_radii
    # Detach radius: first z-independent vertical station.
    r_detach = wall_max * 1.3
    if invasion.size:
        r_min_inv = float(np.min(invasion))
        if r_min_inv * 0.8 > wall_max:
            r_detach = min(r_detach, max(r_min_inv * 0.8, wall_max * 1.05))
        else:
            r_detach = (wall_max + r_min_inv) / 2 if r_min_inv > wall_max else r_detach

    n_far_lines = spec.nr - spec.n_wall_cells - spec.n_blend_cells
    far = _graded_1d(
        r_detach,
        R,
        n_far_lines,
        [(np.array([r_detach]), spec.h_min_radial, spec.slope_radial)]
        + ([(invasion, spec.h_min_radial, spec.slope_radial)] if invasion.size else []),
        spec.h_max_radial_frac * R,
    )
    far = _snap(far, invasion[(invasion > r_detach) & (invasion < R)])
    return z_lines, wall_of_z, far, r_detach


@dataclasses.dataclass
class Grid2DLight:
    """Profile-only grid: the device-meshing staging unit.

    Carries exactly what the on-device builder (meshing/device_mesh.py) and the
    host-side readout logic need — ~7 KB per batch instead of the ~3 MB of
    coords/sigma arrays the full :class:`Grid2D` stages.
    """

    spec: GridSpec2D
    domain_radius: float
    z_axis: np.ndarray  # (NZ,)
    wall_of_z: np.ndarray  # (NZ,)
    far: np.ndarray  # (NR - n_wall_cells - n_blend_cells,)
    r_detach: float
    bottoms: np.ndarray  # (L,) layer bottom depths (recentered)
    fz_radius: np.ndarray  # (L,) NaN = no invasion
    sigma_fz: np.ndarray  # (L,)
    sigma_uz: np.ndarray  # (L,)
    mud_sigma: float

    @property
    def grid_shape(self):
        return (self.spec.nz, self.spec.nr)

    def axis_node_index(self, z: float, tol: float = 1e-3) -> int:
        i = int(np.argmin(np.abs(self.z_axis - z)))
        if abs(self.z_axis[i] - z) > tol:
            raise ValueError(f"no grid line at z={z} (nearest {self.z_axis[i]})")
        return i

    def content_bytes(self) -> bytes:
        """Stable content signature for the checkpoint key."""
        parts = [self.z_axis, self.wall_of_z, self.far,
                 np.asarray([self.r_detach, self.mud_sigma]),
                 self.bottoms, self.fz_radius, self.sigma_fz, self.sigma_uz]
        return b"".join(np.ascontiguousarray(p).tobytes() for p in parts)


def build_grid2d_light(
    spec: GridSpec2D,
    domain_radius: float,
    local_model: LocalModel,
    electrode_positions: np.ndarray,
    source_positions: np.ndarray,
) -> Grid2DLight:
    """Profile-only build for the device-meshing path (dip == 0)."""
    z_lines, wall_of_z, far, r_detach = build_profiles_2d(
        spec, domain_radius, local_model, electrode_positions, source_positions
    )
    return Grid2DLight(
        spec=spec,
        domain_radius=float(domain_radius),
        z_axis=z_lines,
        wall_of_z=wall_of_z,
        far=far,
        r_detach=float(r_detach),
        bottoms=np.asarray(local_model.bottoms, dtype=float),
        fz_radius=np.asarray(local_model.fz_radius, dtype=float),
        sigma_fz=np.asarray(local_model.sigma_fz, dtype=float),
        sigma_uz=np.asarray(local_model.sigma_uz, dtype=float),
        mud_sigma=float(local_model.mud_sigma),
    )


def build_grid2d(
    spec: GridSpec2D,
    domain_radius: float,
    local_model: LocalModel,
    electrode_positions: np.ndarray,
    source_positions: np.ndarray,
) -> Grid2D:
    """Build one batch's grid from the carved local model and electrode layout."""
    R = float(domain_radius)
    z_lines, wall_of_z, far, r_detach = build_profiles_2d(
        spec, R, local_model, electrode_positions, source_positions
    )

    # Node radial positions (NZ, NR): inside-wall fractions scale with the local wall
    # radius; blend stations interpolate from the wall to the detach radius.
    f_in = np.linspace(0.0, 1.0, spec.n_wall_cells + 1)  # axis..wall inclusive
    f_blend = np.linspace(0.0, 1.0, spec.n_blend_cells + 1)[1:]  # (0, 1]
    r_nodes = np.empty((spec.nz, spec.nr))
    r_nodes[:, : spec.n_wall_cells + 1] = wall_of_z[:, None] * f_in[None, :]
    r_nodes[:, spec.n_wall_cells + 1 : spec.n_wall_cells + spec.n_blend_cells + 1] = (
        wall_of_z[:, None] + (r_detach - wall_of_z[:, None]) * f_blend[None, :]
    )
    r_nodes[:, spec.n_wall_cells + spec.n_blend_cells + 1 :] = far[None, 1:]

    z_nodes = np.broadcast_to(z_lines[:, None], (spec.nz, spec.nr)).copy()

    # ---- Conductivity sampling (before blending: near field is conforming) --------
    zc = 0.25 * (
        z_nodes[:-1, :-1] + z_nodes[1:, :-1] + z_nodes[:-1, 1:] + z_nodes[1:, 1:]
    )
    rc = 0.25 * (
        r_nodes[:-1, :-1] + r_nodes[1:, :-1] + r_nodes[:-1, 1:] + r_nodes[1:, 1:]
    )
    sigma_cells = _sample_sigma(local_model, zc, rc)
    sigma_cells[:, : spec.n_wall_cells] = local_model.mud_sigma  # borehole column
    layer_idx, invaded = _sample_region(local_model, zc, rc)
    layer_idx[:, : spec.n_wall_cells] = -1  # mud column
    invaded[:, : spec.n_wall_cells] = False

    # ---- Squircle blend to the exact circular boundary ----------------------------
    z_b, r_b = _squircle_blend(z_nodes, r_nodes, R, spec.blend_m0)
    coords = np.stack([z_b, r_b], axis=-1)

    free_mask = np.ones((spec.nz, spec.nr), dtype=bool)
    free_mask[0, :] = False
    free_mask[-1, :] = False
    free_mask[:, -1] = False

    return Grid2D(
        spec=spec,
        z_axis=z_lines,
        coords=coords,
        sigma_cells=sigma_cells,
        free_mask=free_mask,
        region_layer=layer_idx,
        region_invaded=invaded,
    )


def _sample_region(
    local_model: LocalModel, zc: np.ndarray, rc: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(local layer index, invaded mask) at cell centroids (dip == 0).

    Layer lookup by z; invasion zone where r < FZ_radius. First/last layers extend
    to infinity (the reference stretches them past the domain instead,
    gmsh_functions.py:141-152).
    """
    bottoms = local_model.bottoms
    idx = np.clip(np.searchsorted(bottoms, zc), 0, bottoms.size - 1)
    fz_r = np.nan_to_num(local_model.fz_radius[idx], nan=-1.0)
    invaded = rc < fz_r
    return idx.astype(np.int32), invaded


def _sample_sigma(local_model: LocalModel, zc: np.ndarray, rc: np.ndarray) -> np.ndarray:
    """Piecewise-constant conductivity at cell centroids (dip == 0)."""
    idx, invaded = _sample_region(local_model, zc, rc)
    sigma = np.where(
        invaded,
        np.nan_to_num(local_model.sigma_fz[idx], nan=0.0),
        local_model.sigma_uz[idx],
    )
    return sigma
