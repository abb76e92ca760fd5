# -*- coding: utf-8 -*-
"""On-device 2D grid construction from 1D profiles (staging-traffic removal).

Counterpart of ``remo3d_tpu.meshing.device_mesh``. The boundary-fitted 2D grid
is a closed-form function of four small 1D profiles (axial lines, caliper wall,
far radial stations, detach radius) and the carved layer tables
(meshing/grid2d.py:build_profiles_2d). Instead of staging the assembled
(NZ, NR) coordinate and conductivity arrays for every batch, the executor stages
the profiles (a few KB per batch) and this module builds the arrays on the
device, batched over the leading axis:

* radial node positions: wall-scaled fractions, blend stations to the detach
  radius, shared far stations (grid2d.py's r_nodes construction);
* cell conductivities: layer lookup by centroid z (searchsorted over padded
  layer bottoms), invasion where r < FZ radius, mud in the wall column
  (grid2d.py:_sample_sigma parity);
* squircle blend onto the exact circular truncation boundary
  (grid2d.py:_squircle_blend parity).
"""

from __future__ import annotations

import torch


def device_mesh_2d(
    z_lines, wall, far, r_detach, bottoms, fz_radius, sigma_fz, sigma_uz,
    n_layers, mud_sigma, R, *, nz, nr, n_wall_cells, n_blend_cells, blend_m0,
):
    """Batched profiles -> (coords (B,NZ,NR,2), sigma (B,NZ-1,NR-1), free (B,NZ,NR)).

    z_lines, wall (B, NZ); far (B, NR - n_wall_cells - n_blend_cells); r_detach,
    mud_sigma (B,); n_layers (B,) integer; layer tables (B, L) padded to a common
    length: ``bottoms`` with +inf (so the lookup never selects a pad entry below
    ``n_layers``), conductivities with benign values. R is the domain radius.
    """
    B = z_lines.shape[0]
    dtype, device = z_lines.dtype, z_lines.device
    wc, bc = n_wall_cells, n_blend_cells

    f_in = torch.linspace(0.0, 1.0, wc + 1, dtype=dtype, device=device)
    f_blend = torch.linspace(0.0, 1.0, bc + 1, dtype=dtype, device=device)[1:]
    wall_ = wall[:, :, None]
    r_wall = wall_ * f_in
    r_blend = wall_ + (r_detach[:, None, None] - wall_) * f_blend
    r_far = far[:, None, 1:].expand(B, nz, nr - wc - bc - 1)
    r_nodes = torch.cat([r_wall, r_blend, r_far], dim=2)
    z_nodes = z_lines[:, :, None].expand(B, nz, nr)

    # Conductivity at centroids BEFORE blending (near field is conforming).
    def centroid(x):
        return 0.25 * (x[:, :-1, :-1] + x[:, 1:, :-1] + x[:, :-1, 1:] + x[:, 1:, 1:])

    zc, rc = centroid(z_nodes), centroid(r_nodes)
    # torch.searchsorted needs the sorted table's leading dims on the values:
    # flatten each batch's centroids into one row. side="left" as in JAX.
    idx = torch.searchsorted(bottoms.contiguous(), zc.reshape(B, -1).contiguous())
    idx = torch.minimum(idx, (n_layers.to(idx.dtype) - 1)[:, None]).clamp_min(0)

    def lookup(table):
        return torch.gather(table, 1, idx).reshape(zc.shape)

    fz_r = lookup(fz_radius)
    fz_r = torch.where(torch.isnan(fz_r), torch.full_like(fz_r, -1.0), fz_r)
    invaded = rc < fz_r
    s_fz = lookup(sigma_fz)
    s_fz = torch.where(torch.isnan(s_fz), torch.zeros_like(s_fz), s_fz)
    sigma = torch.where(invaded, s_fz, lookup(sigma_uz))
    sigma = torch.cat(
        [mud_sigma[:, None, None].expand(B, nz - 1, wc), sigma[:, :, wc:]], dim=2
    )

    # Squircle blend (grid2d.py:_squircle_blend parity).
    zn = z_nodes / R
    rn = r_nodes / R
    m = torch.maximum(torch.abs(zn), torch.abs(rn))
    s = torch.clamp((m - blend_m0) / (1.0 - blend_m0), 0.0, 1.0)
    w = s * s * (3.0 - 2.0 * s)
    one = torch.ones_like(m)
    q = torch.where(m > 0, torch.hypot(zn, rn) / torch.where(m > 0, m, one), one)
    f = (1.0 - w) + w / torch.where(q > 0, q, one)
    coords = torch.stack([z_nodes * f, r_nodes * f], dim=-1)

    free = torch.ones((nz, nr), dtype=torch.bool, device=device)
    free[0, :] = False
    free[-1, :] = False
    free[:, -1] = False
    return coords, sigma, free.expand(B, nz, nr)
