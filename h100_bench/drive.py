# -*- coding: utf-8 -*-
"""The one general generator and driver of the benchmark's traffic.

A traffic mix is a data file (``traffic/<mix>.json``) that names an entry
kind and its parameters; a configuration is a data file
(``configs/<config>.json``) that holds the deployment. This module turns the
two and a seed into requests and drives the program with them:

* ``simulate_logs``: each request is one log through the public
  ``remo3d_tpu_torch.model.Model.simulate_logs``, of the traffic's tools and
  depths ("all" = the configuration's);
* ``lm_step``: each request is one Levenberg-Marquardt iteration of an
  inversion, ``DifferentiableLog.forward(p)`` then ``.jacobian(p)``, on a
  ``DifferentiableLog`` built once in set-up.

Request i draws its inputs from ``(seed, i)`` alone, so a run's inputs do not
depend on how many requests its window holds: every layer's resistivities
(``simulate_logs``: the undisturbed and the invaded value of a row by
one factor) or every inversion parameter (``lm_step``) is multiplied by a
factor drawn log-uniformly in ``resistivity_factor``'s [low, high]. The geometry, the mud and the
shapes stay those of the configuration.

The program is imported inside the entries, never at module level.
"""

from __future__ import annotations

import numpy as np

from .reference import log as ref_log


def table(rows) -> np.ndarray:
    """A table from JSON rows, null as NaN."""
    return np.array([[np.nan if v is None else v for v in row] for row in rows], dtype=float)


def depths_of(spec) -> np.ndarray:
    return spec["start"] + spec["step"] * np.arange(spec["count"])


def rng_of(seed: int, i: int) -> np.random.Generator:
    """Request i's generator (i = -1: the warm request of set-up)."""
    return np.random.default_rng([seed % 2**63, i + 1])


def factors(rng: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    lo, hi = np.log(spec["low"]), np.log(spec["high"])
    return np.exp(rng.uniform(lo, hi, n))


class Workload:
    """A configuration under a traffic mix, with the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.formation0 = table(config["formation"])
        self.borehole = table(config["borehole"])
        self.tools = config["tools"] if traffic["tools"] == "all" else traffic["tools"]
        self.depths = depths_of(config["depths"] if traffic["depths"] == "all"
                                else traffic["depths"])
        self.spec_grid = tuple(config["grid"][k] for k in (
            ("nz", "np_", "nr") if "np_" in config["grid"] else ("nz", "nr")))
        self.case = ref_log.Case(self.tools, self.depths, self.formation0, self.borehole,
                                 float(config["dip"]), config["grid"],
                                 config.get("metric3d", "cylindrical"))

    # ---- the inputs of request i ------------------------------------------------
    def formation(self, i: int) -> np.ndarray:
        """Each row's resistivities times one drawn factor."""
        f = factors(rng_of(self.seed, i), self.formation0.shape[0],
                    self.traffic["resistivity_factor"])
        out = self.formation0.copy()
        out[:, 3] *= f
        out[:, 4] *= f
        return out

    def params0(self) -> np.ndarray:
        """The inversion parameters of the configuration's table: every row's
        undisturbed resistivity, then the invaded one of each invaded row."""
        fm = self.formation0
        return np.concatenate([fm[:, 4], fm[~np.isnan(fm[:, 2]), 3]])

    def params(self, i: int) -> np.ndarray:
        """Each inversion parameter times its own drawn factor."""
        p0 = self.params0()
        return p0 * factors(rng_of(self.seed, i), p0.size, self.traffic["resistivity_factor"])

    def formation_of_params(self, p) -> np.ndarray:
        fm = self.formation0.copy()
        L = fm.shape[0]
        fm[:, 4] = p[:L]
        fm[~np.isnan(fm[:, 2]), 3] = p[L:]
        return fm

    def check_sample(self, n_requests: int, n_batches: int) -> dict:
        """{request: [batch, ...]}: the (request, batch) pairs that the check
        compares, drawn from the seed among all the window's."""
        k = min(int(self.traffic["check"]["batches"]), n_requests * n_batches)
        rng = np.random.default_rng([self.seed % 2**63, 0, 1])
        picked = sorted(rng.choice(n_requests * n_batches, size=k, replace=False).tolist())
        out: dict = {}
        for j in picked:
            out.setdefault(j // n_batches, []).append(j % n_batches)
        return out


def _gap(prog: float, ref: float) -> float:
    """Relative gap of a program value from the reference's (inf for NaN)."""
    gap = abs(prog / ref - 1.0)
    return gap if np.isfinite(gap) else float("inf")


class SimulateLogs:
    """Entry ``simulate_logs``: one whole log per request."""

    def __init__(self, w: Workload, device: str):
        import torch

        from remo3d_tpu_torch.meshing.grid2d import GridSpec2D
        from remo3d_tpu_torch.meshing.grid3d import GridSpec3D
        from remo3d_tpu_torch.model import Model

        self.w = w
        self.model = Model(list(w.tools))
        cfg = w.config
        self.kwargs = {"device": device, "dtype": cfg["dtype"], "tol": cfg["tol"],
                       "verbose": False}
        if w.case.is3d:
            self.kwargs["grid_spec3d"] = GridSpec3D(**cfg["grid"])
            self.kwargs["executor_overrides"] = {"metric3d": w.case.metric3d}
        else:
            self.kwargs["grid_spec"] = GridSpec2D(**cfg["grid"])
        self.sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
        self.n_batches = len(ref_log.Plan(w.case).tasks)

    def request(self, i: int) -> dict:
        w = self.w
        self.model.set_model_parameters(w.formation(i), w.borehole,
                                        borehole_geometry_type="radius", dip=w.case.dip)
        self.model.simulate_logs(w.depths, **self.kwargs)
        self.sync()
        values = np.stack([self.model.logs[t][:, 1] for t in w.tools], axis=1)
        rep = self.model.last_report
        failed = bool(rep["n_failed_solves"]) or not np.isfinite(values).all()
        return {"values": values, "work": int(values.size), "failed": failed,
                "phases": dict(rep["phases"]), "chunks": list(rep["chunks"]),
                "n_solve_slots": rep["n_solve_slots"]}

    def release(self) -> None:
        self.model.shutdown_workers()
        self.model = None

    def reference(self, r: int, batches, precision: str, device: str) -> dict:
        """{(measurement, tool): readout} of the reference for request r."""
        return ref_log.readouts(ref_log.Plan(self.w.case), batches,
                                formation=self.w.formation(r), precision=precision,
                                device=device)

    def compare(self, record: dict, ref: dict) -> dict:
        """The widest relative gap of the record's readouts from ``ref``'s."""
        if "values" not in record:  # the request raised
            return {"readout_gap": float("inf")}
        return {"readout_gap": max(_gap(record["values"][k], v) for k, v in ref.items())}

    def as_record(self, ref: dict) -> dict:
        """A record that holds ``ref``'s answers (for the control)."""
        values = np.full((len(self.w.depths), len(self.w.tools)), np.nan)
        for k, v in ref.items():
            values[k] = v
        return {"values": values}


class LMStep:
    """Entry ``lm_step``: one Levenberg-Marquardt iteration per request."""

    def __init__(self, w: Workload, device: str):
        import torch

        from remo3d_tpu_torch.diff import DifferentiableLog
        from remo3d_tpu_torch.meshing.grid2d import GridSpec2D
        from remo3d_tpu_torch.meshing.grid3d import GridSpec3D
        from remo3d_tpu_torch.model import Model

        self.w = w
        cfg = w.config
        model = Model(list(w.tools))
        model.set_model_parameters(w.formation0, w.borehole, borehole_geometry_type="radius",
                                   dip=w.case.dip)
        grid = ({"grid_spec3d": GridSpec3D(**cfg["grid"]), "metric3d": w.case.metric3d}
                if w.case.is3d else {"grid_spec": GridSpec2D(**cfg["grid"])})
        self.dlog = DifferentiableLog(model, w.depths, tol=cfg["tol"],
                                      chunk_size=int(w.traffic["chunk_size"]),
                                      device=device, **grid)
        if not np.allclose(self.dlog.params0, w.params0()):
            raise RuntimeError("the program's parameters are not the configuration's")
        self.sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
        self.n_batches = len(ref_log.Plan(w.case).tasks)

    def request(self, i: int) -> dict:
        p = self.w.params(i)
        values = self.dlog.forward(p)
        forward = self.dlog.last_report["chunks"]
        jac = self.dlog.jacobian(p)
        jacobian = self.dlog.last_report["chunks"]
        self.sync()
        values, jac = values.double().cpu().numpy(), jac.double().cpu().numpy()
        measured = np.isfinite(values)
        failed = not (np.isfinite(jac).all() and measured.any())
        return {"values": values, "jacobian": jac, "work": 1, "failed": failed,
                "calls": {"forward": forward, "jacobian": jacobian}}

    def release(self) -> None:
        self.dlog = None

    def reference(self, r: int, batches, precision: str, device: str) -> dict:
        """{(measurement, tool): (readout, its row of the Jacobian)} of the
        reference at request r's parameters. The Jacobian is the central
        difference of the reference's log at a relative step of STEP."""
        w = self.w
        plan = ref_log.Plan(w.case)
        p = w.params(r)

        def log(q):
            return ref_log.readouts(plan, batches, formation=w.formation_of_params(q),
                                    precision=precision, device=device)

        ref = log(p)
        rows = {k: np.zeros(p.size) for k in ref}
        for j in range(p.size):
            h = STEP * p[j]
            up, down = p.copy(), p.copy()
            up[j] += h
            down[j] -= h
            hi, lo = log(up), log(down)
            for k in ref:
                rows[k][j] = (hi[k] - lo[k]) / (2 * h)
        return {k: (v, rows[k]) for k, v in ref.items()}

    def compare(self, record: dict, ref: dict) -> dict:
        """The widest relative gap of a forward value from the reference's,
        and of a Jacobian row: the largest gap of an entry over the row's
        largest reference entry."""
        if "values" not in record:  # the request raised
            return {"forward_gap": float("inf"), "jacobian_gap": float("inf")}
        fwd = jac = 0.0
        for k, (v, row) in ref.items():
            fwd = max(fwd, _gap(record["values"][k], v))
            gap = np.abs(record["jacobian"][k] - row).max() / np.abs(row).max()
            jac = max(jac, gap if np.isfinite(gap) else float("inf"))
        return {"forward_gap": fwd, "jacobian_gap": jac}

    def as_record(self, ref: dict) -> dict:
        shape = (len(self.w.depths), len(self.w.tools))
        P = self.w.params0().size
        values, jac = np.full(shape, np.nan), np.zeros(shape + (P,))
        for k, (v, row) in ref.items():
            values[k], jac[k] = v, row
        return {"values": values, "jacobian": jac}


def check(entry, records: list, device: str, sample: dict | None = None) -> dict:
    """Each number the cell compares, its widest over the sample of the
    window's (request, batch) pairs drawn from the seed (``sample``, by
    default :meth:`Workload.check_sample`'s): the program's answers against
    the float64 reference's."""
    if sample is None:
        sample = entry.w.check_sample(len(records), entry.n_batches)
    out: dict = {}
    for r, batches in sample.items():
        numbers = entry.compare(records[r], entry.reference(r, batches, "float64", device))
        out = {k: float(max(v, out.get(k, 0.0))) for k, v in numbers.items()}
    return out


STEP = 1e-4
ENTRIES = {"simulate_logs": SimulateLogs, "lm_step": LMStep}
