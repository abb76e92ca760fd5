# -*- coding: utf-8 -*-
# Frozen copy of remo3d_tpu_torch/planner.py at commit 214ab07, for the benchmark's
# reference; the benchmark never imports the program's module.
"""Simulation-depth planning: SEC dedup, batching, and task construction.

Behavioral parity with the reference planner (remo3d.py:602-692):

* per-tool simulation depths = measurement depths + tool depth shift, rounded to 4
  decimals;
* in SEC mode (all tools single-current-electrode) depths shared by several tools are
  deduplicated — one FEM solve serves every tool whose current electrode lands there;
* depths are padded with NaN into (n_batches, batch_size); the batch center is the
  nanmean of its depths and every solve is expressed as an offset from that center;
* each batch carries the union of all electrode offsets it needs ("combined tools"),
  which drives a single mesh per batch; each solve carries its own source electrodes;
  each readout maps (measurement depth, tool) to potential-electrode offsets.

The output is a list of :class:`BatchTask` that the executor converts into padded
arrays for the device pipeline.

A numpy copy of ``remo3d_tpu.planner``; tests/test_torch_host.py pins the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .tools import ToolParameters


@dataclasses.dataclass
class Readout:
    """One apparent-resistivity readout: evaluate the potential at the tool's
    measuring electrodes (worker.py:113-134)."""

    measurement_index: int
    tool_index: int
    offset: float  # solve offset from the batch center (already included in positions)
    measuring_positions: np.ndarray  # z-offsets from batch center of M (and N) nodes
    geometric_factor: float


@dataclasses.dataclass
class SolveTask:
    """One linear solve on the batch mesh: point sources at ``source_positions`` with
    strengths ``source_terms`` (+1/−1)."""

    simulation_depth_index: int
    source_positions: np.ndarray  # z-offsets from batch center, rounded to 4 decimals
    source_terms: np.ndarray  # matching strengths (nonzero entries only)
    readouts: list[Readout]


@dataclasses.dataclass
class BatchTask:
    """One mesh + several solves sharing it (reference task tuple, remo3d.py:679-690)."""

    batch_index: int
    center_depth: float  # nanmean of the batch's simulation depths, rounded 4dp
    electrode_positions: np.ndarray  # union of all electrode offsets needed (sorted)
    solves: list[SolveTask]


def plan_tasks(
    tools: dict[str, ToolParameters],
    sec: bool,
    measurement_depths: np.ndarray,
    batch_size: int,
) -> tuple[np.ndarray, list[BatchTask]]:
    """Build the batch/solve/readout plan.

    Returns (combined_simulation_depths, tasks); combined depths index the per-batch
    mud-resistivity lookup (remo3d.py:806) exactly as in the reference.
    """
    measurement_depths = np.asarray(measurement_depths, dtype=float)
    tool_names = list(tools.keys())

    tools_simulation_depths = {
        name: np.round(measurement_depths + tools[name].depth_shift, decimals=4)
        for name in tool_names
    }

    if sec:
        simulation_depths = np.unique(np.hstack(list(tools_simulation_depths.values())))
        simulated_tool_indices = None
    else:
        simulation_depths = np.hstack(list(tools_simulation_depths.values()))
        simulated_tool_indices = np.repeat(
            np.arange(len(tool_names)), len(measurement_depths)
        )
        order = np.argsort(simulation_depths, kind="stable")
        simulation_depths = simulation_depths[order]
        simulated_tool_indices = simulated_tool_indices[order]

    n_batches = int(np.ceil(simulation_depths.size / batch_size))
    padded = np.pad(
        simulation_depths.astype(float),
        (0, n_batches * batch_size - simulation_depths.size),
        mode="constant",
        constant_values=np.nan,
    ).reshape(n_batches, batch_size)
    combined_simulation_depths = np.round(np.nanmean(padded, axis=1), decimals=4)
    offsets = np.round(padded - combined_simulation_depths[:, None], decimals=4)

    tasks: list[BatchTask] = []
    for b in range(n_batches):
        solves: list[SolveTask] = []
        batch_current: list[float] = []
        batch_potential: list[float] = []
        for d in range(batch_size):
            sim_idx = b * batch_size + d
            sim_depth = padded[b, d]
            if np.isnan(sim_depth):
                break
            offset = offsets[b, d]
            readouts: list[Readout] = []
            current_positions: list[float] = []
            current_terms: list[float] = []

            if sec:
                # One solve serves all tools whose current electrode is at this depth.
                for ti, name in enumerate(tool_names):
                    tp = tools[name]
                    if not np.any(np.isclose(tools_simulation_depths[name], sim_depth)):
                        continue
                    meas_idx = int(
                        np.argwhere(
                            np.isclose(measurement_depths + tp.depth_shift, sim_depth)
                        )[0][0]
                    )
                    positions = np.round(tp.geometry + offset, 4)
                    src_mask = tp.source_terms != 0
                    readouts.append(
                        Readout(
                            measurement_index=meas_idx,
                            tool_index=ti,
                            offset=float(offset),
                            measuring_positions=positions[~src_mask],
                            geometric_factor=tp.geometric_factor,
                        )
                    )
                    for p, s in zip(positions[src_mask], tp.source_terms[src_mask]):
                        if not any(np.isclose(p, q) for q in current_positions):
                            current_positions.append(float(p))
                            current_terms.append(float(s))
                    batch_current += list(positions[src_mask])
                    batch_potential += list(positions[~src_mask])
            else:
                ti = int(simulated_tool_indices[sim_idx])
                name = tool_names[ti]
                tp = tools[name]
                meas_idx = int(
                    np.argwhere(
                        np.isclose(measurement_depths + tp.depth_shift, sim_depth)
                    )[0][0]
                )
                positions = np.round(tp.geometry + offset, 4)
                src_mask = tp.source_terms != 0
                readouts.append(
                    Readout(
                        measurement_index=meas_idx,
                        tool_index=ti,
                        offset=float(offset),
                        measuring_positions=positions[~src_mask],
                        geometric_factor=tp.geometric_factor,
                    )
                )
                current_positions = [float(p) for p in positions[src_mask]]
                current_terms = [float(s) for s in tp.source_terms[src_mask]]
                batch_current += list(positions[src_mask])
                batch_potential += list(positions[~src_mask])

            solves.append(
                SolveTask(
                    simulation_depth_index=sim_idx,
                    source_positions=np.asarray(current_positions),
                    source_terms=np.asarray(current_terms),
                    readouts=readouts,
                )
            )

        unique_current = np.unique(np.asarray(batch_current))
        unique_potential = np.unique(np.asarray(batch_potential))
        unique_potential = unique_potential[~np.isin(unique_potential, unique_current)]
        electrode_positions = np.sort(np.hstack([unique_potential, unique_current]))

        tasks.append(
            BatchTask(
                batch_index=b,
                center_depth=float(combined_simulation_depths[b]),
                electrode_positions=electrode_positions,
                solves=solves,
            )
        )

    return combined_simulation_depths, tasks
