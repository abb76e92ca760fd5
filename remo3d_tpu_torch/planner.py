# -*- coding: utf-8 -*-
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

The output is bit-equal to ``remo3d_tpu.planner`` (tests/test_torch_host.py pins it),
which scans every depth vector once per solve; here each tool's depth matches and
electrode positions are looked up once per log.
"""

from __future__ import annotations

import dataclasses
import itertools

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


def _first_close(values: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """For each target, the first index ``i`` with ``np.isclose(values[i], target)``,
    or -1: ``np.argwhere(np.isclose(values, target))`` per target, without the
    (targets x values) scan.

    A window of twice isclose's tolerance around each target picks the candidates
    from the sorted values; ``np.isclose`` itself confirms them.
    """
    order = np.argsort(values, kind="stable")
    ranked = values[order]
    width = 2.0 * (1e-8 + 1e-5 * np.abs(targets))
    # fmin / fmax keep an infinite target's window on the target itself.
    lo = np.searchsorted(ranked, np.fmin(targets - width, targets), side="left")
    hi = np.searchsorted(ranked, np.fmax(targets + width, targets), side="right")
    counts = hi - lo
    owner = np.repeat(np.arange(targets.size), counts)
    rank = lo[owner] + np.arange(owner.size) - np.repeat(np.cumsum(counts) - counts, counts)
    close = np.isclose(ranked[rank], targets[owner])
    first = np.full(targets.size, values.size)
    np.minimum.at(first, owner[close], order[rank[close]])
    return np.where(first < values.size, first, -1)


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

    # Per tool and simulation depth, once for the whole log: whether the tool is
    # simulated there (SEC: its current electrode lands on the depth), its first
    # matching measurement index, and its electrode positions at the solve offset.
    n_sim = simulation_depths.size
    sim_depths = padded.reshape(-1)[:n_sim]
    sim_offsets = offsets.reshape(-1)[:n_sim]
    serves = np.empty((len(tool_names), n_sim), dtype=bool)
    meas_index = np.empty((len(tool_names), n_sim), dtype=int)
    current, terms, potential, current_tool, potential_tool = [], [], [], [], []
    for ti, name in enumerate(tool_names):
        tp = tools[name]
        if sec:
            serves[ti] = _first_close(tools_simulation_depths[name], sim_depths) >= 0
        else:
            serves[ti] = simulated_tool_indices == ti
        meas_index[ti] = _first_close(measurement_depths + tp.depth_shift, sim_depths)
        positions = np.round(tp.geometry[None, :] + sim_offsets[:, None], 4)
        src_mask = tp.source_terms != 0
        current.append(positions[:, src_mask])
        potential.append(positions[:, ~src_mask])
        terms.append(np.broadcast_to(tp.source_terms[src_mask].astype(float), current[-1].shape))
        current_tool += [ti] * int(src_mask.sum())
        potential_tool += [ti] * int((~src_mask).sum())
    # Solves of a batch stop at its first NaN (padding).
    reached = np.cumprod(~np.isnan(padded), axis=1).astype(bool)
    serves &= reached.reshape(-1)[:n_sim]
    if np.any(serves & (meas_index < 0)):
        raise IndexError("a simulated depth matches no measurement depth of its tool")

    # Each solve's electrodes, tool by tool, and which of its sources it keeps: in
    # SEC mode a source is dropped when it is close to one kept before it.
    current_all, terms_all = np.hstack(current), np.hstack(terms)
    potential_all = np.hstack(potential)
    current_in, potential_in = serves[current_tool].T, serves[potential_tool].T
    kept = current_in.copy()
    if sec:
        for j in range(kept.shape[1]):
            for i in range(j):
                kept[:, j] &= ~(kept[:, i] & np.isclose(current_all[:, j], current_all[:, i]))

    serving = serves.T.tolist()
    meas_index = meas_index.tolist()
    factors = [tools[name].geometric_factor for name in tool_names]
    sim_offsets_list = sim_offsets.tolist()
    n_solves = reached.sum(axis=1).tolist()
    tasks: list[BatchTask] = []
    for b in range(n_batches):
        solves: list[SolveTask] = []
        for sim_idx in range(b * batch_size, b * batch_size + n_solves[b]):
            offset = sim_offsets_list[sim_idx]
            readouts = [
                Readout(
                    measurement_index=meas_index[ti][sim_idx],
                    tool_index=ti,
                    offset=offset,
                    measuring_positions=potential[ti][sim_idx],
                    geometric_factor=factors[ti],
                )
                for ti in itertools.compress(range(len(tool_names)), serving[sim_idx])
            ]
            keep = kept[sim_idx]
            solves.append(
                SolveTask(
                    simulation_depth_index=sim_idx,
                    source_positions=current_all[sim_idx][keep],
                    source_terms=terms_all[sim_idx][keep],
                    readouts=readouts,
                )
            )

        # The batch's electrodes: the sorted distinct positions of its solves' sources
        # (kept or not) and measuring electrodes.
        rows = slice(b * batch_size, b * batch_size + len(solves))
        unique_current = np.unique(current_all[rows][current_in[rows]])
        unique_potential = np.unique(potential_all[rows][potential_in[rows]])
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
