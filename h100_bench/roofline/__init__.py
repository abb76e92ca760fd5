# -*- coding: utf-8 -*-
"""The yardstick of the kernels' rooflines: the card's peaks and the least
bytes of the operations the per-layer metrics divide by device time.

Frozen copies, taken at commit 214ab07 of this repository, of
``remo3d_tpu_torch/kernels/pcr_lines.py`` (``coefficient_values``,
``line_view``, ``least_work``), ``remo3d_tpu_torch/ops/lines.py``
(``_n_steps``), ``remo3d_tpu_torch/parallel/runtime.py``
(``_feasible_mg_levels``) and ``remo3d_tpu_torch/bench.py`` (``_pcr_apply``,
``traffic_multigrid_2d``, ``traffic_adi_3d`` and the helpers they use). The
benchmark never imports them from the program, so a change there cannot move
the yardstick.

Bytes are counted for the work of an operation, whatever kernel does it:
every array an apply needs is read once and every array it makes is written
once, nothing is taken to stay in the L2 cache between applies, and only the
batches that carry a measurement count (a chunk's padded lanes are the
program's choice, not work the log needs).
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, NVIDIA's data sheet: HBM3 bytes/s and float32 FLOP/s
# outside the tensor cores, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def n_steps(n: int, max_steps: int | None = None) -> int:
    """PCR levels of a line of n nodes (``ops/lines.py`` ``_n_steps``)."""
    steps = max(1, math.ceil(math.log2(max(n, 2))))
    return steps if max_steps is None else min(steps, max_steps)


def feasible_mg_levels(*dims: int, want: int = 4) -> int:
    """Multigrid levels a grid allows (``runtime._feasible_mg_levels``)."""
    levels = 1
    step = 1
    while levels < want and all((n - 1) % (2 * step) == 0 for n in dims):
        levels += 1
        step *= 2
    return levels


def coefficient_values(n: int, L: int) -> int:
    """Coefficients that an apply of L levels reads on one line of n nodes:
    alpha_k at i >= s and beta_k at i < n - s for each level with s = 2^k <
    n (a level with s >= n changes nothing), then dinv at every node."""
    return n + sum(2 * (n - 2**k) for k in range(L) if 2**k < n)


def line_view(shape: tuple, axis: int) -> tuple[int, int, int]:
    """(outer, n, inner) of lines along ``axis`` of a grid ``shape``."""
    outer = math.prod(shape[:axis])
    return outer, shape[axis], math.prod(shape[axis + 1:])


def least_work(B: int, S: int, grid, axis: int, L: int, itemsize: int) -> tuple[int, int]:
    """(bytes, flops) that one line apply of L levels to S solves per batch
    cannot do without: b read and x written once, the coefficients of
    :func:`coefficient_values` read once per batch; per solve a multiply and
    an add for each coefficient term, and the product with dinv."""
    outer, n, inner = line_view(tuple(grid), axis)
    lines, coef = B * outer * inner, coefficient_values(n, L)
    return itemsize * lines * (2 * S * n + coef), S * lines * (2 * coef - n)


# ---------------------------------------------------------------------------
# The line applies (K3's operation) of the two iterative routes
# ---------------------------------------------------------------------------


def line_applies_adi_3d(iterations: int) -> list[tuple[str, int]]:
    """(direction, applies) of a 3D chunk's PCG under the z-p-r-p-z ADI
    sweep: one sweep before the loop and one per iteration."""
    sweeps = iterations + 1
    return [("z", 2 * sweeps), ("p", 2 * sweeps), ("r", sweeps)]


def k3_bytes_adi_3d(B: int, S: int, grid: tuple, iterations: int, itemsize: int) -> int:
    """Least bytes of the line applies of a 3D chunk (``grid`` (NZ, NP, NR))."""
    axis = {"z": 0, "p": 1, "r": 2}
    total = 0
    for d, count in line_applies_adi_3d(iterations):
        L = n_steps(grid[axis[d]])
        total += count * least_work(B, S, grid, axis[d], L, itemsize)[0]
    return total


def line_applies_multigrid_2d(iterations: int, n_levels: int, degree: int = 2,
                              coarse_degree: int = 24, power_iters: int = 6):
    """(level, vectors, line_rz applies) of a 2D chunk's PCG under the
    Galerkin multigrid V-cycle with the ``line_rz`` smoother: per V-cycle
    ``degree`` Chebyshev steps before and after the coarse correction on each
    level above the coarsest and ``coarse_degree`` on it, one V-cycle before
    the loop and one per iteration, on S vectors; at set-up ``power_iters``
    steps of the spectral estimate per level, on one vector. Each line_rz
    apply solves along r, then along z."""
    cycles = iterations + 1
    out = []
    for level in range(n_levels):
        per_cycle = coarse_degree if level == n_levels - 1 else 2 * degree
        out.append((level, "S", cycles * per_cycle))
        out.append((level, 1, power_iters))
    return out


def k3_bytes_multigrid_2d(B: int, S: int, nz: int, nr: int, iterations: int, itemsize: int,
                          *, degree: int = 2, coarse_degree: int = 24,
                          power_iters: int = 6) -> int:
    """Least bytes of the line applies of a 2D chunk on an NZ x NR grid."""
    n_levels = feasible_mg_levels(nz, nr)
    total = 0
    for level, vectors, count in line_applies_multigrid_2d(
            iterations, n_levels, degree, coarse_degree, power_iters):
        grid = ((nz - 1) // 2**level + 1, (nr - 1) // 2**level + 1)
        s = S if vectors == "S" else 1
        for axis in (1, 0):  # r, then z
            total += count * least_work(B, s, grid, axis, n_steps(grid[axis]), itemsize)[0]
    return total


def k2_bytes(B: int, S: int, grid: tuple, itemsize: int) -> int:
    """Least bytes of one apply of the 3D operator in half storage (K2): the
    14 half planes once per batch, u read and y written once per solve."""
    return (14 + 2 * S) * B * math.prod(grid) * itemsize


def k2_applies_adi_3d(iterations: int) -> int:
    """Operator applies of a 3D chunk's PCG under ADI: the matvec and the
    sweep's four residuals per iteration, the boundary lift and the first
    sweep's four before the loop."""
    return 5 * (iterations + 1)


def k1_bytes(B: int, S: int, grid: tuple, itemsize: int) -> int:
    """Least bytes of one apply of the 2D operator in half storage (K1): the
    5 half planes once per batch, u read and y written once per solve."""
    return (5 + 2 * S) * B * math.prod(grid) * itemsize


# ---------------------------------------------------------------------------
# The solve's whole traffic per route (remo3d_tpu_torch/bench.py at 214ab07)
# ---------------------------------------------------------------------------


def pcr_apply(k: int, vec: int, plane: int, n: int, kernel: bool = False) -> int:
    """A factored PCR line apply of k levels on lines of n nodes: per level x,
    alpha, beta read and x written; then x * dinv. With ``kernel``, its least
    bytes: b read and x written once, and of each line the coefficients that
    the function reads (:func:`coefficient_values`) once."""
    if kernel:
        return 2 * vec + plane // n * coefficient_values(n, k)
    return k * (2 * vec + 2 * plane) + 2 * vec + plane


def pcr_factor(k: int, plane: int) -> int:
    """A PCR factorization of k levels: per level a, c, d read and alpha,
    beta, a, c, d written; then dinv from d."""
    return (8 * k + 2) * plane


def cg(iterations: int, vec: int, matvec: int, precond: int) -> int:
    """Preconditioned CG: |b|^2, M^-1 b and r.z before the loop; per iteration
    r.r, the matvec, p.Ap, the u and r updates, M^-1 r, r.z and the p update;
    r.r at the exit and the final residual."""
    return 4 * vec + precond + iterations * (matvec + 14 * vec + precond) + vec


def _load_2d(B, S, nz, nr, f):
    """Assembly, the Dirichlet elimination, and the singularity-subtracted
    load with its lift."""
    n = nz * nr
    p, v, m = B * n * f, S * B * n * f, B * n
    cells = B * (nz - 1) * (nr - 1) * f
    assembly = 2 * p + cells + 9 * p
    dirichlet = 9 * p + m + 9 * p
    load = (2 * p + v) + (2 * p + cells + v) + (v + m + v) + (9 * p + 2 * v) + 3 * v + (2 * v + m)
    return assembly + dirichlet + load + 4 * v


def traffic_multigrid_2d(B, S, nz, nr, iterations, *, itemsize=4, n_levels=4, degree=2,
                         coarse_degree=24, power_iters=6, kernel_levels=2, line_steps=None,
                         pcr_kernel=False):
    """Least bytes of a 2D chunk's PCG under the Galerkin multigrid V-cycle
    (smoother ``line_rz``), set-up included: K1 (5 planes) on the
    ``kernel_levels`` finest levels, the 9-point apply below; the line solves
    through K3 with ``pcr_kernel``."""
    f = itemsize
    levels = []
    for l in range(n_levels):
        nzl, nrl = (nz - 1) // 2**l + 1, (nr - 1) // 2**l + 1
        n = nzl * nrl
        levels.append(dict(p=B * n * f, v=S * B * n * f, m=B * n, nz=nzl, nr=nrl,
                           kz=n_steps(nzl, line_steps), kr=n_steps(nrl, line_steps),
                           planes=5 if l < kernel_levels else 9))

    def line_rz(L, vec, plane):
        return (pcr_apply(L["kr"], vec, plane, L["nr"], pcr_kernel)
                + pcr_apply(L["kz"], vec, plane, L["nz"], pcr_kernel) + 3 * vec)

    def apply_(L):
        return L["planes"] * L["p"] + 2 * L["v"]

    def chebyshev(L, deg):
        if deg <= 0:
            return 0
        step = apply_(L) + 3 * L["v"] + L["m"] + line_rz(L, L["v"], L["p"])
        return deg * step + 5 * L["v"] + (deg - 1) * 6 * L["v"]

    def v_cycle(l):
        L = levels[l]
        if l == n_levels - 1:
            return chebyshev(L, coarse_degree)
        coarse = levels[l + 1]["v"]
        return (chebyshev(L, degree) + apply_(L) + 3 * L["v"] + L["m"]
                + (L["v"] + coarse) + v_cycle(l + 1) + (coarse + L["v"])
                + 3 * L["v"] + L["m"] + chebyshev(L, degree))

    setup = _load_2d(B, S, nz, nr, f)
    for l, L in enumerate(levels):
        p = L["p"]
        setup += 2 * p + pcr_factor(L["kr"], p) + pcr_factor(L["kz"], p)
        if l < kernel_levels:
            setup += 14 * p
        setup += power_iters * (11 * p + line_rz(L, p, p) + 4 * p)
        if l < n_levels - 1:
            q = levels[l + 1]
            setup += 9 * (q["p"] + p) + 27 * p + 9 * (p + q["p"]) + 18 * q["p"] + (
                18 * q["p"] + q["m"])
    setup += 14 * levels[0]["p"] if kernel_levels else 0
    return setup + cg(iterations, levels[0]["v"], apply_(levels[0]), v_cycle(0))


def _load_3d(B, S, nz, np_, nr, f, use_kernel):
    """Assembly, Dirichlet elimination, the half planes of both stencils and
    the singularity-subtracted load with its lift and its pole tie."""
    n = nz * np_ * nr
    p, v, m = B * n * f, S * B * n * f, B * n
    cells = B * (nz - 1) * (np_ - 1) * (nr - 1) * f
    assembly = 3 * p + cells + 27 * p
    dirichlet = 27 * p + m + 27 * p
    halves = 2 * 28 * p if use_kernel else 0
    lift = (14 if use_kernel else 27) * p + 2 * v
    load = (3 * p + v) + (3 * p + cells + v) + (v + m + v) + lift + 3 * v + (2 * v + m) + 2 * v
    return assembly + dirichlet + halves + load


def traffic_adi_3d(B, S, nz, np_, nr, iterations, *, itemsize=4, use_kernel=True,
                   pcr_kernel=False):
    """Least bytes of a 3D chunk's pole-tied PCG under the damped z-p-r-p-z
    ADI sweep, set-up included; each pole tie copies the vector; the line
    solves through K3 with ``pcr_kernel``."""
    f = itemsize
    n = nz * np_ * nr
    p, v = B * n * f, S * B * n * f
    lengths = {"z": nz, "p": np_, "r": nr}
    k = {d: n_steps(m) for d, m in lengths.items()}
    matvec = 14 * p + 2 * v if use_kernel else 27 * p + 2 * v + 4 * v
    pole = 2 * v
    sweep = pole + pcr_apply(k["z"], v, p, nz, pcr_kernel) + pole + 2 * v
    for d in ("p", "r", "p", "z"):
        sweep += matvec + 3 * v + pcr_apply(k[d], v, p, lengths[d], pcr_kernel) + pole + 3 * v
    setup = _load_3d(B, S, nz, np_, nr, f, use_kernel) + sum(pcr_factor(k[d], p) for d in k)
    return setup + cg(iterations, v, matvec, sweep)
