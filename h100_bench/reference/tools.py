# -*- coding: utf-8 -*-
# Frozen copy of remo3d_tpu_torch/tools.py at commit 214ab07, for the benchmark's
# reference; the benchmark never imports the program's module.
"""Logging-tool specification parser.

Parses tool names like ``"B5.7A0.4M"`` (three electrodes out of {A, B, M, N} listed
top→bottom with the two inter-electrode distances in meters) into a numeric parameter
block, computes the geometric factor K and the tool's depth shift, and optionally
rewrites two-current-electrode tools into the reciprocal single-current-electrode form.

Behavioral parity with the reference implementation
(reference remo3d.py:178-340); written from scratch.

A numpy copy of ``remo3d_tpu.tools``; tests/test_torch_host.py pins the two equal.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

_TOKEN_RE = re.compile(r"([A-Za-z]+)|([0-9]*\.?[0-9]+)")
_VALID_ELECTRODES = {"A", "B", "M", "N"}
# Reciprocity rewrite: swap current and potential electrodes (A<->M, B<->N).
_RECIPROCAL = str.maketrans("ABMN", "MNAB")


@dataclasses.dataclass(frozen=True)
class ToolParameters:
    """Numeric description of one logging tool.

    Attributes
    ----------
    name: the original tool name string (dictionary key in the public API).
    geometry: (3,) z-offsets of the three physical electrodes relative to the tool's
        current-electrode center, sorted ascending (reference array row 0, cols 0-2).
    source_terms: (3,) +1/-1 for current electrodes, 0 for potential electrodes,
        aligned with ``geometry`` (reference row 1, cols 0-2).
    geometric_factor: K = |4π·d1·d2/(d2−d1)| (reference row 0, col 3).
    depth_shift: offset from measurement depth to the simulation (source) depth
        (reference row 1, col 3).
    """

    name: str
    geometry: np.ndarray
    source_terms: np.ndarray
    geometric_factor: float
    depth_shift: float

    @property
    def as_array(self) -> np.ndarray:
        """2x4 array in the reference layout: row0 = [geometry, K],
        row1 = [source_terms, depth_shift]."""
        return np.vstack(
            [
                np.hstack([self.geometry, [self.geometric_factor]]),
                np.hstack([self.source_terms, [self.depth_shift]]),
            ]
        )

    @property
    def is_single_current(self) -> bool:
        """True when the tool injects through exactly one current electrode."""
        return bool(np.sum(self.source_terms) != 0)

    @property
    def measuring_offsets(self) -> np.ndarray:
        """z-offsets of the potential (readout) electrodes."""
        return self.geometry[self.source_terms == 0]

    @property
    def source_offsets(self) -> np.ndarray:
        """z-offsets of the current electrodes."""
        return self.geometry[self.source_terms != 0]


def _tokenize(tool: str) -> tuple[tuple[str, ...], list[float]]:
    """Split a tool name into electrode symbols and inter-electrode distances."""
    electrodes: list[str] = []
    distances: list[float] = []
    pos = 0
    for match in _TOKEN_RE.finditer(tool):
        if match.start() != pos:
            raise ValueError(f"{tool} logging tool specification is uncorrect")
        pos = match.end()
        if match.group(1) is not None:
            electrodes.append(match.group(1))
        else:
            distances.append(float(match.group(2)))
    if pos != len(tool):
        raise ValueError(f"{tool} logging tool specification is uncorrect")
    return tuple(electrodes), distances


def parse_tool(tool: str, force_single_electrode_configuration: bool = True) -> ToolParameters:
    """Parse one tool name into :class:`ToolParameters`.

    Mirrors reference semantics (remo3d.py:209-321): the optional reciprocity rewrite
    applies only to tools containing both A and B; electrode positions are centered on
    the current electrode(s); K uses the two electrode spacings of the lone pair.
    """
    if not isinstance(tool, str):
        raise ValueError("tools must be a list of tool-name strings")

    name_for_parse = tool
    if force_single_electrode_configuration and "A" in tool and "B" in tool:
        name_for_parse = tool.translate(_RECIPROCAL)

    electrodes, distances = _tokenize(name_for_parse)

    if (
        len(electrodes) != 3
        or len(distances) != 2
        or min(distances) <= 0
        or len(set(electrodes)) != 3
        or any(e not in _VALID_ELECTRODES for e in electrodes)
    ):
        raise ValueError(f"{tool} logging tool specification is uncorrect")

    # Measurement-point position relative to the top electrode: midpoint of the
    # closer-spaced electrode pair (remo3d.py:258-264). Equal spacings are invalid.
    if distances[0] < distances[1]:
        z_mp = distances[0] / 2
    elif distances[0] > distances[1]:
        z_mp = distances[0] + distances[1] / 2
    else:
        raise ValueError(f"{tool} logging tool specification is uncorrect")

    positions = np.array([0.0, distances[0], distances[0] + distances[1]]) - z_mp
    z = {e: positions[i] for i, e in enumerate(electrodes)}

    if "A" not in z:  # single current electrode B
        d1, d2 = abs(z["B"] - z["M"]), abs(z["B"] - z["N"])
        k = abs(4 * np.pi * d1 * d2 / (d2 - d1))
        depth_shift = z["B"]
        geometry = np.array([z["B"], z["M"], z["N"]])
        source_terms = np.array([1.0, 0.0, 0.0])
    elif "B" not in z:  # single current electrode A
        d1, d2 = abs(z["A"] - z["M"]), abs(z["A"] - z["N"])
        k = abs(4 * np.pi * d1 * d2 / (d2 - d1))
        depth_shift = z["A"]
        geometry = np.array([z["A"], z["M"], z["N"]])
        source_terms = np.array([1.0, 0.0, 0.0])
    elif "M" not in z:  # two current electrodes, potential read at N
        d1, d2 = abs(z["A"] - z["N"]), abs(z["B"] - z["N"])
        k = abs(4 * np.pi * d1 * d2 / (d1 - d2))
        depth_shift = (z["A"] + z["B"]) / 2
        geometry = np.array([z["A"], z["B"], z["N"]])
        source_terms = np.array([1.0, -1.0, 0.0])
    else:  # two current electrodes, potential read at M
        d1, d2 = abs(z["A"] - z["M"]), abs(z["B"] - z["M"])
        k = abs(4 * np.pi * d1 * d2 / (d2 - d1))
        depth_shift = (z["A"] + z["B"]) / 2
        geometry = np.array([z["A"], z["B"], z["M"]])
        source_terms = np.array([1.0, -1.0, 0.0])

    order = np.argsort(geometry)
    geometry = geometry[order] - depth_shift  # center on the current electrode(s)
    source_terms = source_terms[order]

    return ToolParameters(
        name=tool,
        geometry=geometry,
        source_terms=source_terms,
        geometric_factor=float(k),
        depth_shift=float(depth_shift),
    )


def parse_tools(
    tools: list[str], force_single_electrode_configuration: bool = True
) -> tuple[dict[str, ToolParameters], bool]:
    """Parse a list of tool names.

    Returns the parameter dict (keyed by the ORIGINAL names, insertion ordered, as the
    reference does) and the ``sec`` flag — True iff every tool ends up in
    single-current-electrode configuration, which enables solve dedup across tools
    (remo3d.py:222-228).
    """
    if not isinstance(tools, list) or not all(isinstance(s, str) for s in tools):
        raise ValueError("tools must be a list of tool-name strings")
    if not isinstance(force_single_electrode_configuration, bool):
        raise ValueError(
            "The value of parameter force_single_electrode_configuration can be set "
            "only to True or False"
        )

    parsed = {t: parse_tool(t, force_single_electrode_configuration) for t in tools}
    sec = all(p.is_single_current for p in parsed.values())
    return parsed, sec
