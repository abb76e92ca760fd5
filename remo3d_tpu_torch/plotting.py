# -*- coding: utf-8 -*-
"""Result writing and visualization.

Output-format parity with the reference's ``save_results`` kwargs and files
(remo3d.py:902 docstring): logs that share a depth axis are grouped into
``Results_N.txt`` TSVs (names row + units row, ``%.4f``) inside a timestamped
``Results_YYYY_MM_DD__HH_MM_SS/`` folder, plus a ``Results_plot.png``.

The figure itself is an original design (not derived from the reference's
implementation): the formation panel is a resistivity RASTER sampled from the
model on a (radial x depth) grid — the same σ-sampling idea the solver grids use,
which renders dip shear, invasion zones and the caliper-following borehole wall
exactly — and each log track draws its curves in a single axis with a stacked,
per-curve colored header instead of per-curve twin axes.

A copy of ``remo3d_tpu.plotting`` whose matplotlib import lives inside the figure
code: where matplotlib is not installed, ``save_results_impl`` writes the TSVs,
says that it drew no figure, and returns the folder.
"""

from __future__ import annotations

import datetime
import os

import numpy as np


def _write_tsv_groups(logs, measurements_to_save, output_subfolder):
    """Group logs sharing a depth axis into Results_N.txt files (byte format
    contract: names row, units row, tab-separated %.4f)."""
    if measurements_to_save == "auto":
        measurements_to_save = list(logs.keys())
    remaining = list(measurements_to_save)
    file_number = 1
    while remaining:
        lead = remaining[0]
        group = [
            name
            for name in remaining
            if logs[name][:, 0].shape == logs[lead][:, 0].shape
            and np.allclose(logs[name][:, 0], logs[lead][:, 0])
        ]
        for name in group:
            remaining.remove(name)
        data = np.column_stack([logs[lead][:, 0]] + [logs[n][:, 1] for n in group])
        header = (
            "\t".join(["DEPTH"] + group) + "\n" + "\t".join(["M"] + ["OHMM"] * len(group))
        )
        np.savetxt(
            os.path.join(output_subfolder, f"Results_{file_number}.txt"),
            data,
            fmt="%.4f",
            delimiter="\t",
            header=header,
            comments="",
        )
        file_number += 1


def _smooth_logs(logs, factor):
    """Cubic display smoothing by the given oversampling factor."""
    from scipy.interpolate import make_interp_spline

    out = {}
    for name, log in logs.items():
        z = log[:, 0]
        dense = np.linspace(z[0], z[-1], int(z.size * factor))
        finite = np.isfinite(log[:, 1])
        if finite.sum() >= 4:
            spline = make_interp_spline(z[finite], log[finite, 1], k=3)
            vals = spline(dense)
            # Keep NaN gaps where the source log had them.
            gap = np.interp(dense, z, np.where(finite, 0.0, 1.0)) > 1e-9
            vals[gap] = np.nan
            out[name] = np.column_stack([dense, vals])
        else:
            out[name] = log
    return out


def _sample_model_raster(formation, borehole, dip_deg, rad_lim, depth_lim, n=(400, 600)):
    """Resistivity raster over (radius, depth) — dip shear + invasion zones +
    caliper wall evaluated exactly at each pixel center."""
    nx, nz = n
    xs = np.linspace(rad_lim[0], rad_lim[1], nx)
    zs = np.linspace(depth_lim[0], depth_lim[1], nz)
    X, Z = np.meshgrid(xs, zs)
    a = np.tan(np.deg2rad(float(dip_deg)))
    zeta = Z - a * X  # layer-frame depth: dip planes are zeta = const

    tops = formation[:, 0]
    bottoms = formation[:, 1]
    idx = np.clip(np.searchsorted(bottoms, zeta), 0, formation.shape[0] - 1)
    # Pixels above/below the described stack show the nearest layer.
    res = formation[idx, 4].astype(float)
    fz_r = formation[idx, 2]
    fz_res = formation[idx, 3]
    in_fz = ~np.isnan(fz_r) & (np.abs(X) < np.nan_to_num(fz_r, nan=-1.0))
    res = np.where(in_fz, np.nan_to_num(fz_res, nan=np.inf), res)

    if borehole is not None:
        wall = np.interp(zs, borehole[:, 0], borehole[:, 1])[:, None]
        mud = np.interp(zs, borehole[:, 0], borehole[:, 2])[:, None]
        res = np.where(np.abs(X) < wall, mud, res)
    del tops
    return xs, zs, res


def save_results_impl(
    logs,
    formation_parameters,
    borehole_parameters,
    dip,
    output_folder=None,
    measurements_to_save="auto",
    plot_layout="auto",
    plot_depth_lim="auto",
    plot_aspect_ratio="auto",
    model_rad_lim="auto",
    model_res_lim="auto",
    logs_res_lim="auto",
    logs_at_nan="break",
    logs_interpolation_factor=1,
    logs_colours="auto",
):
    """Write grouped TSVs + the summary figure; show interactively when
    ``output_folder`` is None (reference remo3d.py:902 behavior)."""
    if logs is None:
        raise ValueError("No logs to save - run simulate_logs first")
    if logs_at_nan not in ("break", "continue"):
        raise ValueError('logs_at_nan must be "break" or "continue"')
    logs = {k: np.asarray(v, dtype=float) for k, v in logs.items()}
    output_subfolder = None

    if output_folder is not None:
        stamp = datetime.datetime.now().strftime("%Y_%m_%d__%H_%M_%S")
        output_subfolder = os.path.join(output_folder, f"Results_{stamp}/")
        os.makedirs(output_subfolder, exist_ok=True)
        _write_tsv_groups(logs, measurements_to_save, output_subfolder)

    # ---- Figure (original layout) -------------------------------------------------
    try:
        import matplotlib
    except ImportError:
        if output_subfolder is None:
            raise
        print(f"results: {output_subfolder} (Results_N.txt only: matplotlib is not installed, "
              "so no figure was drawn)", flush=True)
        return output_subfolder

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    if logs_interpolation_factor > 1:
        logs = _smooth_logs(logs, logs_interpolation_factor)

    formation = np.array(formation_parameters, dtype=float, copy=True)
    borehole = None if borehole_parameters is None else np.asarray(borehole_parameters)

    if plot_depth_lim == "auto":
        zmin = min(float(np.nanmin(log[:, 0])) for log in logs.values())
        zmax = max(float(np.nanmax(log[:, 0])) for log in logs.values())
        pad = 0.05 * (zmax - zmin or 1.0)
        plot_depth_lim = [zmin - pad, zmax + pad]
    if model_rad_lim == "auto":
        fz = formation[:, 2]
        half_width = (
            3.0 * float(np.nanmax(fz))
            if not np.all(np.isnan(fz))
            else 12.0 * float(np.nanmax(borehole[:, 1])) if borehole is not None else 1.0
        )
        model_rad_lim = [-half_width, half_width]

    track_layout = [list(logs.keys())] if plot_layout == "auto" else plot_layout
    n_tracks = len(track_layout)

    if logs_res_lim == "auto":
        lo = min(float(np.nanmin(log[:, 1])) for log in logs.values())
        hi = max(float(np.nanmax(log[:, 1])) for log in logs.values())
        span = hi - lo or 1.0
        logs_res_lim = [max(0.0, lo - 0.08 * span), hi + 0.08 * span]

    if plot_aspect_ratio == "auto":
        depth_span = plot_depth_lim[1] - plot_depth_lim[0]
        plot_aspect_ratio = float(np.clip(depth_span / 30.0, 0.6, 2.5))

    panel_w = 4.2
    fig_w = panel_w * (1 + n_tracks) + 1.2
    fig_h = max(4.0, 7.0 * plot_aspect_ratio)
    fig = plt.figure(figsize=(fig_w, fig_h), layout="constrained")
    gs = fig.add_gridspec(1, 1 + n_tracks)

    # Model panel: raster + borehole axis marker.
    ax_model = fig.add_subplot(gs[0, 0])
    xs, zs, raster = _sample_model_raster(
        formation, borehole, dip, model_rad_lim, plot_depth_lim
    )
    finite = raster[np.isfinite(raster)]
    if model_res_lim == "auto":
        norm = LogNorm(vmin=max(finite.min(), 1e-3), vmax=finite.max())
    else:
        # A log colour scale cannot start at 0 (Example_02 asks for [0, 20]).
        norm = LogNorm(vmin=max(model_res_lim[0], 1e-3), vmax=model_res_lim[1])
    mesh = ax_model.pcolormesh(xs, zs, raster, norm=norm, cmap="viridis", shading="auto")
    ax_model.axvline(0.0, color="k", lw=0.8, ls=(0, (4, 2)))
    ax_model.set_ylim(plot_depth_lim[1], plot_depth_lim[0])  # depth grows downward
    ax_model.set_xlabel("distance from axis [m]")
    ax_model.set_ylabel("depth [m]")
    ax_model.set_title(f"Formation model (dip {dip}\N{DEGREE SIGN})")
    fig.colorbar(mesh, ax=ax_model, location="right", label="resistivity [ohmm]", shrink=0.85)

    # Log tracks: one axis per track, stacked colored headers for curve labels.
    palette = (
        plt.rcParams["axes.prop_cycle"].by_key()["color"]
        if logs_colours == "auto"
        else None
    )
    for ti, names in enumerate(track_layout):
        ax = fig.add_subplot(gs[0, 1 + ti], sharey=ax_model)
        colours = palette if palette is not None else logs_colours[ti]
        for ci, name in enumerate(names):
            log = logs[name]
            colour = colours[ci % len(colours)]
            vals = log[:, 1]
            if logs_at_nan == "continue":
                keep = np.isfinite(vals)
                ax.plot(vals[keep], log[keep, 0], color=colour, lw=1.2)
            else:  # "break": NaN samples leave gaps
                ax.plot(vals, log[:, 0], color=colour, lw=1.2)
            ax.text(
                0.02 + 0.98 * ci / max(len(names), 1),
                1.005 + 0.0 * ci,
                name,
                transform=ax.transAxes,
                color=colour,
                fontsize=9,
                ha="left",
                va="bottom",
            )
        ax.set_xlim(logs_res_lim)
        ax.set_xlabel("apparent resistivity [ohmm]")
        ax.grid(True, which="both", alpha=0.4)
        ax.tick_params(labelleft=False)

    if output_subfolder is not None:
        fig.savefig(os.path.join(output_subfolder, "Results_plot.png"), dpi=150)
        plt.close(fig)
    else:
        # Interactive mode (reference: output_folder=None displays the figure).
        plt.show()
    return output_subfolder
