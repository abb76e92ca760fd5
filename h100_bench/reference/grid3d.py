# -*- coding: utf-8 -*-
# Frozen copy of remo3d_tpu_torch/meshing/grid3d.py at commit 214ab07, for the benchmark's
# reference; the benchmark never imports the program's module.
"""Boundary-fitted structured hex grid for the 3D dipping-layer problem.

Replaces the reference's per-task gmsh 3D meshes (half-sphere + revolved borehole +
rotated layer boxes + invasion half-cylinders, gmsh_functions.py:544-684) with a
fixed-topology sheared-cylindrical grid over the half-ball y >= 0:

* axial lines graded/snapped exactly like the 2D builder (electrodes + the depths
  where dipping layer planes cross the borehole axis);
* radial stations wall-following inside the borehole, snapped to invasion radii —
  vertical cylinders stay grid-conforming because the dip shear only moves z;
* a TAPERED DIP SHEAR ``z = zeta + tan(dip)*x*clamp*taper`` makes the dipping layer
  planes (z = z_b + tan(dip)*x, the rotation the reference applies to layer boxes,
  gmsh_functions.py:607-617) grid-conforming near the tool; the shear is clamped to
  0.2R and tapered to zero at the axial ends so no cell can invert and the domain
  boundary stays put (far-field non-conformity is absorbed by centroid sigma
  sampling, exactly like the far-field squircle region in 2D);
* the 2D squircle blend applied in the (z, rho) meridian plane maps the outer grid
  onto the EXACT sphere of ``domain_radius`` (the reference's Dirichlet surface);
* the azimuth spans [0, pi]: the y=0 symmetry plane is a natural Neumann boundary
  and readouts are halved, matching the reference's half-space convention
  (worker.py:129-131).

Axis ordering: (i = axial, j = azimuth, k = radial station). Station k=0 is the
borehole axis; its coincident azimuth DOFs are tied by the solver's pole projector.

A numpy copy of ``remo3d_tpu.meshing.grid3d`` (the JAX package cannot be
imported without JAX); tests/test_torch_host.py pins the two bit-equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .carve import LocalModel
from .grid2d import _graded_1d, _snap, _squircle_blend

# Minimum radial cells across an invasion annulus before it counts as
# under-resolved (shared with the model-layer auto-refine rule).
THIN_ANNULUS_MIN_CELLS = 4.0


@dataclasses.dataclass(frozen=True)
class GridSpec3D:
    """Static 3D grid topology + grading parameters."""

    nz: int = 193  # axial lines; nz-1 divisible by 8 for multigrid
    np_: int = 17  # azimuth lines over [0, pi]; np_-1 divisible by 8
    nr: int = 49  # radial stations; nr-1 divisible by 8
    n_wall_cells: int = 6
    n_blend_cells: int = 3
    h_min_source: float = 0.01
    slope_source: float = 0.5
    h_min_electrode: float = 0.04
    slope_electrode: float = 0.7
    h_min_boundary: float = 0.08
    slope_boundary: float = 1.2
    h_max_axial_frac: float = 0.15
    h_min_radial: float = 0.03
    slope_radial: float = 0.5
    h_max_radial_frac: float = 0.15
    # Anchor spacing for UNDER-RESOLVED invasion boundaries only (annulus over
    # the max caliper thinner than THIN_ANNULUS_MIN_CELLS * h_min_radial).
    # None = all invasion anchors use h_min_radial. Set by the thin-annulus
    # auto rule (model._thin_annulus_refine): refining only the thin anchors
    # keeps the fixed radial station budget from starving the mid-field —
    # a global h_min_radial cut was measured to IMPROVE the thin 0.2 m bed but
    # REGRESS the well-resolved 0.5 m bed ~4x (scratch/screen_bm2_thin.py).
    fz_h_radial: float | None = None
    blend_m0: float = 0.35
    shear_cap_frac: float = 0.2  # max |shear offset| as a fraction of R
    # Azimuth lines are spaced uniformly. Clustering them toward phi = 0/pi
    # (where the bilinear facets sag furthest off a dipping plane) was measured
    # against the rotated layered oracle and made every config WORSE (dip 60:
    # 0.73% -> 0.89/0.98% at cluster strengths 0.4/0.6) — the non-uniform
    # sub-cell sigma mix it induces costs more than the conformity gain buys.
    # Conductivity rule for cells cut by a dipping layer plane: "centroid"
    # (nearest-layer lookup at the cell center) or sub-cell homogenization over
    # the cell's zeta = z - tan(dip)*x extent — "arithmetic" (exact for current
    # flowing along the layering), "harmonic" (exact across), "mixed"
    # (geometric mean of the two, the isotropic compromise between the
    # Cardwell–Parsons bounds). Measured vs the rotated layered oracle on the
    # BM3 stack at dip 30 (benchmarks/bm3_oracle.py): arithmetic is best
    # (max 2.36% / mean 0.33%, vs 2.52/0.36 centroid, 2.74/0.36 harmonic).
    sigma_blend: str = "arithmetic"

    @classmethod
    def fast(cls) -> "GridSpec3D":
        """~2x-faster preset (2.2x fewer nodes). Under the cylindrical
        assembly metric (the default, ops/assembly3d.py) azimuth resolution is
        nearly free at dips <= 45 (np_=9 matches np_=17 at dip->0), so the
        accuracy cost concentrates at high dip (np_=9: dip 60 max 2.6% vs 1.05%
        default). Pass via ``simulate_logs(grid_spec3d=GridSpec3D.fast())``."""
        return cls(nz=177, np_=9, nr=45)

    @classmethod
    def accurate(cls) -> "GridSpec3D":
        """High-accuracy preset: finer azimuth, which under the cylindrical
        metric only matters at HIGH dip (rotated-oracle measurement,
        benchmarks/bm3_oracle.py: dip 60 max 1.05% -> 0.78%; dips <= 45
        unchanged at <= 0.43%)."""
        return cls(np_=25)

    @classmethod
    def high_dip(cls) -> "GridSpec3D":
        """Steep-dip preset: refined meridian AND azimuth. The dip->0 study
        proved the meridian (nz, nr) is the binding resolution axis
        (193x49 -> 1.01% gap, 257x65 -> 0.51%, scratch/dip0_gap.py) while at
        dip 60 azimuth still pays (np_=17 -> 1.05%, np_=25 -> 0.78% on the
        default meridian); combining both, the rotated layered-medium oracle
        (benchmarks/bm3_oracle.py --nz=257 --nr=65 --np=25) measures dip 60 at
        **max 0.50% / mean 0.23%** vs 1.05% on the default grid — the level the
        reference reaches with order-3 unstructured FEM. 2.6x the nodes of the
        default grid. Selected AUTOMATICALLY by ``Model.simulate_logs`` when
        dip >= 50 deg and no explicit ``grid_spec3d`` is given."""
        return cls(nz=257, np_=25, nr=65)


@dataclasses.dataclass
class Grid3D:
    spec: GridSpec3D
    z_axis: np.ndarray  # (NZ,) axial line positions (exact on the borehole axis)
    coords: np.ndarray  # (NZ, NP, NR, 3) physical (x, y, z)
    sigma_cells: np.ndarray  # (NZ-1, NP-1, NR-1)
    free_mask: np.ndarray  # (NZ, NP, NR)
    # Differentiable-path provenance (remo3d_tpu.diff), None unless
    # ``with_regions`` was requested: per-cell LOCAL-layer weights such that
    # sigma_uz_cell = weights @ sigma_uz (exactly _zeta_average_sigma for the
    # "arithmetic" blend; centroid one-hot otherwise), the centroid layer of
    # invaded cells (-1 elsewhere), and the fixed (mud-column) mask.
    region_uz_weights: np.ndarray | None = None  # (NZ-1, NP-1, NR-1, L)
    region_fz_layer: np.ndarray | None = None  # (NZ-1, NP-1, NR-1) int32
    region_fixed: np.ndarray | None = None  # (NZ-1, NP-1, NR-1) bool

    def axis_node_index(self, z: float, tol: float = 1e-3) -> int:
        i = int(np.argmin(np.abs(self.z_axis - z)))
        if abs(self.z_axis[i] - z) > tol:
            raise ValueError(
                f"position {z} is not a grid line (nearest {self.z_axis[i]:.5f})"
            )
        return i


def _zeta_average_sigma(zeta_lo, zeta_hi, zeta_c, bottoms, sigma_uz, blend):
    """Average the piecewise-constant sigma_uz(zeta) over [zeta_lo, zeta_hi].

    ``bottoms`` are the layer bottoms (ascending, last one unbounded below);
    the interior knots are ``bottoms[:-1]``. "arithmetic" averages sigma,
    "harmonic" averages resistivity, "mixed" takes the geometric mean of the
    two (isotropic compromise between the Cardwell–Parsons bounds). Degenerate
    (zero-extent) cells fall back to the centroid value.
    """
    knots = bottoms[:-1]
    idx_c = np.clip(np.searchsorted(bottoms, zeta_c), 0, sigma_uz.size - 1)
    centroid = sigma_uz[idx_c]

    def avg(vals):
        # F(z) = int_{knots[0]}^{z} vals(zeta) dzeta for piecewise-constant vals.
        c_at_knot = np.concatenate(
            [[0.0], np.cumsum(vals[1 : knots.size] * np.diff(knots))]
        )

        def F(z):
            i = np.clip(np.searchsorted(knots, z), 0, vals.size - 1)
            ref = knots[np.maximum(i - 1, 0)]
            base = np.where(i == 0, 0.0, c_at_knot[np.maximum(i - 1, 0)])
            ref = np.where(i == 0, knots[0], ref)
            return base + vals[i] * (z - ref)

        ext = zeta_hi - zeta_lo
        with np.errstate(divide="ignore", invalid="ignore"):
            mean = (F(zeta_hi) - F(zeta_lo)) / ext
        return np.where(ext > 1e-12, mean, vals[idx_c])

    if blend == "arithmetic":
        return avg(sigma_uz)
    if blend == "harmonic":
        return 1.0 / avg(1.0 / sigma_uz)
    if blend == "mixed":
        return np.sqrt(avg(sigma_uz) / avg(1.0 / sigma_uz))
    raise ValueError(f"unknown sigma_blend {blend!r}")


def _zeta_overlap_weights(zeta_lo, zeta_hi, idx_c, bottoms):
    """Per-cell layer weights of the ARITHMETIC sub-cell blend.

    w_l is the fraction of the cell's zeta extent inside layer l (layer l
    spans (bottoms[l-1], bottoms[l]); first/last layers extend to infinity),
    so ``sigma_cell = sum_l w_l sigma_l`` reproduces
    :func:`_zeta_average_sigma` with ``blend="arithmetic"`` exactly — the
    linear-in-sigma form the differentiable path (remo3d_tpu.diff) traces.
    Degenerate (zero-extent) cells fall back to the centroid one-hot.
    """
    L = bottoms.size
    knots = bottoms[:-1]
    k_hi = np.concatenate([knots, [np.inf]])
    k_lo = np.concatenate([[-np.inf], knots])
    lo = zeta_lo[..., None]
    hi = zeta_hi[..., None]
    ov = np.clip(np.minimum(hi, k_hi) - np.maximum(lo, k_lo), 0.0, None)
    ext = (zeta_hi - zeta_lo)[..., None]
    onehot = np.eye(L)[idx_c]
    return np.where(ext > 1e-12, ov / np.where(ext > 0, ext, 1.0), onehot)


def build_grid3d(
    spec: GridSpec3D,
    domain_radius: float,
    local_model: LocalModel,
    dip_rad: float,
    electrode_positions: np.ndarray,
    source_positions: np.ndarray,
    with_regions: bool = False,
) -> Grid3D:
    R = float(domain_radius)
    a = float(np.tan(dip_rad))
    electrodes = np.asarray(electrode_positions, dtype=float)
    sources = np.asarray(source_positions, dtype=float)

    # ---- Axial lines (as in 2D; boundaries = axis crossings of the dip planes) ----
    boundaries = local_model.boundaries
    near_boundaries = boundaries[np.abs(boundaries) < 0.98 * R]
    z_lines = _graded_1d(
        -R,
        R,
        spec.nz,
        [
            (sources, spec.h_min_source, spec.slope_source),
            (electrodes, spec.h_min_electrode, spec.slope_electrode),
            (near_boundaries, spec.h_min_boundary, spec.slope_boundary),
        ],
        spec.h_max_axial_frac * R,
    )
    z_lines = _snap(z_lines, np.concatenate([electrodes, near_boundaries]))

    # ---- Radial stations (as in 2D) ----------------------------------------------
    bh = local_model.borehole
    wall_of_z = np.interp(z_lines, bh[:, 0], bh[:, 1])
    wall_max = float(np.max(bh[:, 1]))
    invasion = local_model.invasion_radii
    r_detach = wall_max * 1.3
    if invasion.size:
        r_min_inv = float(np.min(invasion))
        if r_min_inv * 0.8 > wall_max:
            r_detach = min(r_detach, max(r_min_inv * 0.8, wall_max * 1.05))
    n_far_lines = spec.nr - spec.n_wall_cells - spec.n_blend_cells
    anchors = [(np.array([r_detach]), spec.h_min_radial, spec.slope_radial)]
    if invasion.size:
        if spec.fz_h_radial is not None:
            thin = (invasion - wall_max) < THIN_ANNULUS_MIN_CELLS * spec.h_min_radial
            if np.any(thin):
                anchors.append((invasion[thin], spec.fz_h_radial, spec.slope_radial))
            if np.any(~thin):
                anchors.append((invasion[~thin], spec.h_min_radial, spec.slope_radial))
        else:
            anchors.append((invasion, spec.h_min_radial, spec.slope_radial))
    far = _graded_1d(
        r_detach,
        R,
        n_far_lines,
        anchors,
        spec.h_max_radial_frac * R,
    )
    far = _snap(far, invasion[(invasion > r_detach) & (invasion < R)])

    phi = np.linspace(0.0, np.pi, spec.np_)

    # ---- Node positions ----------------------------------------------------------
    # Wall radius per (i, j): one fixed-point pass through the shear for the true z.
    cosphi = np.cos(phi)
    sinphi = np.sin(phi)
    shear_cap = spec.shear_cap_frac * R

    def shear_offset(x, zeta):
        raw = a * x
        clamped = np.clip(raw, -shear_cap, shear_cap)
        taper = 1.0 - (zeta / R) ** 2
        return clamped * taper

    z_true_wall = z_lines[:, None] + shear_offset(
        wall_of_z[:, None] * cosphi[None, :], z_lines[:, None]
    )
    wall_ij = np.interp(z_true_wall, bh[:, 0], bh[:, 1])  # (NZ, NP)

    f_in = np.linspace(0.0, 1.0, spec.n_wall_cells + 1)
    f_blend = np.linspace(0.0, 1.0, spec.n_blend_cells + 1)[1:]
    rho = np.empty((spec.nz, spec.np_, spec.nr))
    rho[:, :, : spec.n_wall_cells + 1] = wall_ij[:, :, None] * f_in[None, None, :]
    rho[:, :, spec.n_wall_cells + 1 : spec.n_wall_cells + spec.n_blend_cells + 1] = (
        wall_ij[:, :, None] + (r_detach - wall_ij[:, :, None]) * f_blend[None, None, :]
    )
    rho[:, :, spec.n_wall_cells + spec.n_blend_cells + 1 :] = far[None, None, 1:]

    x = rho * cosphi[None, :, None]
    y = rho * sinphi[None, :, None]
    z = z_lines[:, None, None] + shear_offset(x, z_lines[:, None, None])

    # Squircle blend in the (z, rho) meridian plane -> exact sphere boundary.
    z_b, rho_b = _squircle_blend(z, rho, R, spec.blend_m0)
    scale = np.where(rho > 0, rho_b / np.where(rho > 0, rho, 1.0), 1.0)
    coords = np.stack([x * scale, y * scale, z_b], axis=-1)

    # ---- Conductivity sampling (true-model lookup; shear-exact layer test) --------
    cc = 0.125 * sum(
        coords[i_ : i_ + spec.nz - 1, j_ : j_ + spec.np_ - 1, k_ : k_ + spec.nr - 1]
        for i_ in (0, 1)
        for j_ in (0, 1)
        for k_ in (0, 1)
    )
    xc, yc, zc = cc[..., 0], cc[..., 1], cc[..., 2]
    zeta_c = zc - a * xc  # dipping plane z = z_b + a*x  <=>  z - a*x = z_b
    rc = np.hypot(xc, yc)
    bottoms = local_model.bottoms
    idx = np.clip(np.searchsorted(bottoms, zeta_c), 0, bottoms.size - 1)
    fz_r = np.nan_to_num(local_model.fz_radius[idx], nan=-1.0)
    sigma_uz_cells = local_model.sigma_uz[idx]
    zeta_lo = zeta_hi = None
    if spec.sigma_blend != "centroid" and bottoms.size > 1:
        # Sub-cell homogenization: average sigma_uz over the cell's zeta extent
        # instead of sampling the centroid — first-order-accurate treatment of
        # cells cut by a dipping layer plane (the dominant 3D discretization
        # error at boundary crossings).
        corner_zeta = coords[..., 2] - a * coords[..., 0]
        corners = [
            corner_zeta[i_ : i_ + spec.nz - 1, j_ : j_ + spec.np_ - 1, k_ : k_ + spec.nr - 1]
            for i_ in (0, 1)
            for j_ in (0, 1)
            for k_ in (0, 1)
        ]
        zeta_lo = np.minimum.reduce(corners)
        zeta_hi = np.maximum.reduce(corners)
        sigma_uz_cells = _zeta_average_sigma(
            zeta_lo, zeta_hi, zeta_c, bottoms, local_model.sigma_uz, spec.sigma_blend
        )
    sigma_cells = np.where(
        rc < fz_r,
        np.nan_to_num(local_model.sigma_fz[idx], nan=0.0),
        sigma_uz_cells,
    )
    sigma_cells[:, :, : spec.n_wall_cells] = local_model.mud_sigma

    region_uz_weights = region_fz_layer = region_fixed = None
    if with_regions:
        if zeta_lo is not None and spec.sigma_blend == "arithmetic":
            W = _zeta_overlap_weights(zeta_lo, zeta_hi, idx, bottoms)
        elif zeta_lo is None:  # centroid lookup (or a single layer)
            W = np.eye(bottoms.size)[idx]
        else:
            raise ValueError(
                "differentiable regions require sigma_blend 'arithmetic' or "
                f"'centroid', not {spec.sigma_blend!r} (the harmonic/mixed "
                "blends are nonlinear in sigma)"
            )
        region_uz_weights = W.astype(np.float32)
        region_fz_layer = np.where(rc < fz_r, idx, -1).astype(np.int32)
        region_fz_layer[:, :, : spec.n_wall_cells] = -1
        region_fixed = np.zeros(rc.shape, dtype=bool)
        region_fixed[:, :, : spec.n_wall_cells] = True

    free_mask = np.ones((spec.nz, spec.np_, spec.nr), dtype=bool)
    free_mask[0] = False
    free_mask[-1] = False
    free_mask[:, :, -1] = False

    return Grid3D(
        spec=spec,
        z_axis=z_lines,
        coords=coords,
        sigma_cells=sigma_cells,
        free_mask=free_mask,
        region_uz_weights=region_uz_weights,
        region_fz_layer=region_fz_layer,
        region_fixed=region_fixed,
    )
