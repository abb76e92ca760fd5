# -*- coding: utf-8 -*-
"""Public API: the ``Model`` class, the port of ``remo3d_tpu.Model``.

Same surface as the JAX package: ``compute_synthetic_logs`` (one-shot pipeline),
the lifecycle ``set_model_parameters`` / ``initialize_workers`` /
``simulate_logs`` / ``shutdown_workers``, and ``save_results``. It takes the same
numpy formation and borehole arrays (or files) and returns the same logs: the 2D
axisymmetric solver at dip 0, the 3D dipping-layer solver otherwise. The solves
run on one torch device: the CUDA card by default, which raises when no card is
visible; the CPU only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np

from . import io as mio
from .meshing.grid2d import GridSpec2D
from .meshing.grid3d import THIN_ANNULUS_MIN_CELLS, GridSpec3D
from .parallel.runtime import Executor, ExecutorConfig
from .planner import plan_tasks
from .plotting import save_results_impl
from .tools import parse_tools
from .utils.timers import PhaseTimers, span

conversion_table = mio.CONVERSION_TABLE

# Dip angle (degrees) at or above which the default 3D grid switches to the
# refined GridSpec3D.high_dip() preset: the rotated layered-medium oracle puts
# the default grid at 0.43% max for dips <= 45 but 1.05% at 60, where
# high_dip() measures 0.50% (benchmarks/bm3_oracle.py, the JAX package).
HIGH_DIP_THRESHOLD_DEG = 50.0


def _thin_annulus_refine(spec, formation, borehole):
    """Refine the radial grading when an invasion annulus is under-resolved.

    Returns (spec, notice_or_None). The thinnest annulus is measured against
    the maximum caliper radius; if it spans fewer than
    ``THIN_ANNULUS_MIN_CELLS`` cells of ``spec.h_min_radial``, the spec gets
    ``nr >= 65`` and ``fz_h_radial <= thickness/THIN_ANNULUS_MIN_CELLS``: a
    refinement local to the under-resolved invasion boundaries only.
    """
    spec = spec or GridSpec3D()
    fz = np.asarray(formation[:, 2], dtype=float)
    wall_max = float(np.max(borehole[:, 1]))
    finite = np.isfinite(fz) & (fz > wall_max)
    if not np.any(finite):
        return spec, None
    t_min = float(np.min(fz[finite]) - wall_max)
    if t_min >= THIN_ANNULUS_MIN_CELLS * spec.h_min_radial:
        return spec, None
    target_h = t_min / THIN_ANNULUS_MIN_CELLS
    fz_h = target_h if spec.fz_h_radial is None else min(spec.fz_h_radial, target_h)
    refined = dataclasses.replace(spec, nr=max(spec.nr, 65), fz_h_radial=fz_h)
    notice = (
        f"Note: thinnest invasion annulus ({t_min:.3f} m over the maximum "
        f"caliper) spans < {THIN_ANNULUS_MIN_CELLS:g} radial cells of the "
        f"default 3D grid; auto-refining to nr={refined.nr}, "
        f"fz_h_radial={refined.fz_h_radial:.4f} at the thin invasion anchors "
        "(pass grid_spec3d=GridSpec3D() to override)"
    )
    return refined, notice


def _resolve_spec3d(dip_deg, grid_spec3d, executor_overrides, formation, borehole):
    """Dip- and invasion-aware 3D grid default: an explicit ``grid_spec3d``
    (or an ``executor_overrides['spec3d']``, which replaces the config
    downstream) always wins; otherwise steep dips auto-select
    ``GridSpec3D.high_dip()`` and thin invasion annuli refine the radial
    grading. Returns (spec_or_None, [notices]); None means the ExecutorConfig
    default stands."""
    if grid_spec3d is not None:
        return grid_spec3d, []
    if executor_overrides and "spec3d" in executor_overrides:
        return None, []
    notices = []
    spec = None
    if dip_deg >= HIGH_DIP_THRESHOLD_DEG:
        spec = GridSpec3D.high_dip()
        notices.append(
            f"Note: dip {dip_deg:g} deg >= {HIGH_DIP_THRESHOLD_DEG:g} auto-selects "
            "the refined GridSpec3D.high_dip() grid (~3x solve cost; pass "
            "grid_spec3d=GridSpec3D() to keep the default grid)"
        )
    spec2, notice = _thin_annulus_refine(spec, formation, borehole)
    if notice is not None:
        spec = spec2
        notices.append(notice)
    return spec, notices


class Model:
    """DC-resistivity forward modeling of normal/lateral logging tools in torch."""

    conversion_table = conversion_table

    def __init__(self, tools, force_single_electrode_configuration=True):
        """Initialize the modelling procedure for a set of tools.

        tools: list of tool-name strings, e.g. ``["N2.5M0.25A", "B5.7A0.4M"]``.
        force_single_electrode_configuration: rewrite two-current-electrode tools to
        the reciprocal single-electrode form for solve dedup.
        """
        self.tools, self.sec = parse_tools(tools, force_single_electrode_configuration)
        self.formation_model = None
        self.borehole_model = None
        self.dip_deg = None
        self.dip_rad = None
        self.cpu_workers = None
        self.gpu_workers = None
        self._executor: Executor | None = None
        self.logs = None
        # The last run's executor report (chunks, CG iterations, failed solves)
        # with its phase seconds; kept after shutdown_workers.
        self.last_report = None

    # ------------------------------------------------------------------- one-shot
    @classmethod
    def compute_synthetic_logs(
        cls,
        tools,
        measurement_depths,
        formation_model,
        borehole_model,
        force_single_electrode_configuration=True,
        formation_units=["M", "M", "M"],
        borehole_geometry_type="diameter",
        borehole_units=["M", "M"],
        dip=0,
        cpu_workers=4,
        gpu_workers=0,
        domain_radius=50,
        batch_size=5,
        mesh_generator="auto",
        preconditioner="auto",
        condense=True,
        **simulate_kwargs,
    ):
        """Complete modelling procedure. Extra keyword arguments (``tol``,
        ``grid_spec``, ``device``, ``dtype``, ``verbose``, ...) are forwarded to
        :meth:`simulate_logs`."""
        model = cls(
            tools,
            force_single_electrode_configuration=force_single_electrode_configuration,
        )
        model.set_model_parameters(
            formation_model,
            borehole_model,
            formation_units=formation_units,
            borehole_geometry_type=borehole_geometry_type,
            borehole_units=borehole_units,
            dip=dip,
        )
        model.initialize_workers(cpu_workers=cpu_workers, gpu_workers=gpu_workers)
        model.simulate_logs(
            measurement_depths,
            domain_radius=domain_radius,
            batch_size=batch_size,
            mesh_generator=mesh_generator,
            preconditioner=preconditioner,
            condense=condense,
            **simulate_kwargs,
        )
        model.shutdown_workers()
        return model

    # ------------------------------------------------------------------ model setup
    @span("set_model_parameters")
    def set_model_parameters(
        self,
        formation_model,
        borehole_model,
        formation_units=["M", "M", "M"],
        borehole_geometry_type="diameter",
        borehole_units=["M", "M"],
        dip=0,
    ):
        """Set formation/borehole models from files or arrays (the unit lists
        apply to ndarray input only; model files carry their own units row)."""
        if isinstance(formation_model, str):
            self.formation_model = mio.load_formation_parameters(formation_model)
        elif isinstance(formation_model, np.ndarray):
            self.formation_model = mio.set_formation_parameters(
                formation_model, formation_units
            )

        if isinstance(borehole_model, str):
            self.borehole_model = mio.load_borehole_parameters(
                borehole_model, borehole_geometry_type
            )
        elif isinstance(borehole_model, np.ndarray):
            self.borehole_model = mio.set_borehole_parameters(
                borehole_model, borehole_geometry_type, borehole_units
            )

        self.dip_deg, self.dip_rad = mio.set_dip(dip)
        mio.check_model_geometry(self.formation_model, self.borehole_model)

    # Thin parity wrappers so callers of the reference's loaders keep working.
    def load_formation_parameters(self, formation_model_file):
        return mio.load_formation_parameters(formation_model_file)

    def set_formation_parameters(self, formation_parameters, formation_units=["M", "M", "M"]):
        return mio.set_formation_parameters(formation_parameters, formation_units)

    def load_borehole_parameters(self, borehole_model_file, borehole_geometry_type="diameter"):
        return mio.load_borehole_parameters(borehole_model_file, borehole_geometry_type)

    def set_borehole_parameters(
        self, borehole_parameters, borehole_geometry_type="diameter", borehole_units=["M", "M"]
    ):
        return mio.set_borehole_parameters(
            borehole_parameters, borehole_geometry_type, borehole_units
        )

    def set_dip(self, dip):
        return mio.set_dip(dip)

    # --------------------------------------------------------------------- runtime
    def initialize_workers(self, cpu_workers=4, gpu_workers=0):
        """Validate the worker counts (the same argument errors as the reference);
        the solves run on one torch device whatever the counts."""
        if type(cpu_workers) != int or type(gpu_workers) != int:
            raise ValueError("Worker counts must be integers")
        if cpu_workers < 1:
            raise ValueError("At least one CPU worker is required")
        if gpu_workers < 0:
            raise ValueError("The GPU worker count cannot be negative")
        self.cpu_workers = cpu_workers
        self.gpu_workers = gpu_workers
        self._executor = None  # re-created per simulate_logs configuration

    @span("log")
    def simulate_logs(
        self,
        measurement_depths,
        domain_radius=50,
        batch_size=5,
        mesh_generator="auto",
        preconditioner="auto",
        condense=True,
        tol=None,
        maxiter=1000,
        dtype="float32",
        grid_spec: GridSpec2D | None = None,
        grid_spec3d: GridSpec3D | None = None,
        device=None,
        verbose=True,
        profile_dir=None,
        checkpoint=None,
        executor_overrides: dict | None = None,
    ):
        """Simulate all logs; returns {tool name: (n, 2) [depth, Ra]}.

        ``preconditioner`` (2D): "multigrid", "local", "direct" (the batched
        block-tridiagonal factorization, ``ops/block_direct.py``) or "auto"
        (= "direct" on the CPU, "multigrid" on CUDA); the 3D solver takes
        ``executor_overrides={"precond3d": ...}``: "adi", "lines", "direct" or
        "auto" (= "direct" on the CPU, "adi" on CUDA). The direct solvers'
        schedule is ``executor_overrides={"direct_schedule": ...}`` ("scan",
        "bcr", "fp"; see ``ExecutorConfig``).
        ``device``: a torch device string ("cuda", "cuda:1", "cpu"); None means
        "cuda" and raises when no card is visible. ``tol`` (None = 3e-7 in 2D,
        1e-5 for the singularity-subtracted 3D solve), ``dtype`` ("float32" or
        "float64", both on CUDA and CPU), ``grid_spec`` / ``grid_spec3d`` (when
        omitted, dips >= 50 deg select ``GridSpec3D.high_dip()`` and thin
        invasion annuli refine the radial grading, see ``_resolve_spec3d``) and
        ``executor_overrides`` (a dict of
        :class:`~remo3d_tpu_torch.parallel.runtime.ExecutorConfig` field overrides)
        are as in the JAX package. ``profile_dir`` writes a torch.profiler
        trace of the chunk loop into that directory; ``checkpoint`` (an .npz
        path) keeps per-chunk results, so a rerun of the same configuration
        resumes where the last one stopped. Under several processes
        (``parallel.distributed.initialize_distributed``) every rank calls this
        with the same arguments and gets the whole log.
        """
        start_time = datetime.datetime.now()
        measurement_depths = np.asarray(measurement_depths, dtype=float)
        if tol is None:
            tol = 3e-7 if np.isclose(self.dip_deg, 0) else 1e-5

        domain_radius_alert = False
        for tp in self.tools.values():
            extent = np.max(np.abs(tp.geometry))
            if extent > domain_radius:
                raise ValueError(
                    "Some electrodes lie outside the simulation domain; "
                    "increase domain_radius"
                )
            elif extent > 0.75 * domain_radius:
                domain_radius_alert = True
        if domain_radius_alert:
            print(
                "Warning: some electrodes sit within 25% of the domain boundary; "
                "results may degrade - consider a larger domain_radius"
            )

        # Both reference mesh generators resolve to the same fixed-topology
        # grid; 3D accepts only "gmsh", as the reference does.
        if mesh_generator == "auto":
            mesh_generator = "netgen" if np.isclose(self.dip_deg, 0) else "gmsh"
        if not np.isclose(self.dip_deg, 0) and mesh_generator != "gmsh":
            raise ValueError("The only mesh generator supported in 3D models is gmsh")
        active_window = 0.999 if mesh_generator == "netgen" else 0.99

        timers = PhaseTimers()
        with timers.phase("plan"):
            if self.dip_deg != 0:
                # Densify sparse borehole polylines (3D meshing aid).
                self.borehole_model = mio.add_points_to_borehole(self.borehole_model)

            simulation_depths, tasks = plan_tasks(
                self.tools, self.sec, measurement_depths, batch_size
            )
            if verbose:
                print(f"{len(tasks)} simulation tasks prepared")

            mud_resistivities = np.interp(
                simulation_depths, self.borehole_model[:, 0], self.borehole_model[:, 2]
            )
            grid_spec3d, spec_notices = (
                _resolve_spec3d(
                    self.dip_deg, grid_spec3d, executor_overrides,
                    self.formation_model, self.borehole_model,
                )
                if not np.isclose(self.dip_deg, 0)
                else (grid_spec3d, [])
            )
        if verbose:
            for notice in spec_notices:
                print(notice)
        config_kwargs = {} if grid_spec3d is None else {"spec3d": grid_spec3d}
        config = ExecutorConfig(
            spec=grid_spec or GridSpec2D(),
            tol=tol,
            maxiter=maxiter,
            dtype=dtype,
            preconditioner=preconditioner,
            device=device,
            profile_dir=profile_dir,
            checkpoint=checkpoint,
            **config_kwargs,
        )
        if executor_overrides:
            config = dataclasses.replace(config, **executor_overrides)
        with timers.phase("prepare"):
            executor = Executor(config)
            self._executor = executor

            grids = executor.prepare_batches(
                tasks,
                self.formation_model,
                self.borehole_model[:, :2],
                mud_resistivities,
                domain_radius,
                self.dip_rad,
                active_window,
            )
        results = executor.run(
            tasks,
            grids,
            len(measurement_depths),
            len(self.tools),
            # Half-space convention: only the y >= 0 half-ball is modeled in 3D.
            readout_factor=0.5 if self.dip_deg != 0 else 1.0,
            verbose=verbose,
        )

        logs = {}
        for i, name in enumerate(self.tools.keys()):
            logs[name] = np.vstack([measurement_depths, results[:, i]]).T
        self.logs = logs
        self.last_report = {**executor.last_report,
                            "phases": {**timers.seconds, **executor.timers.seconds}}

        if verbose:
            print("\nProcessed in: ", datetime.datetime.now() - start_time)
            print(executor.timers.report())
        return logs

    def shutdown_workers(self):
        """Release the executor (and the device tensors it holds)."""
        self._executor = None

    # --------------------------------------------------------------------- output
    def save_results(self, output_folder=None, **kwargs):
        """Save Results_N.txt TSVs + Results_plot.png (the figure needs matplotlib)."""
        return save_results_impl(
            logs=self.logs,
            formation_parameters=self.formation_model,
            borehole_parameters=self.borehole_model,
            dip=self.dip_deg,
            output_folder=output_folder,
            **kwargs,
        )
