# -*- coding: utf-8 -*-
"""Batched preconditioned conjugate gradients on stencil operators.

Counterpart of ``remo3d_tpu.ops.cg``. All solves in the batch run lock-step;
converged and empty lanes are frozen by masking, so padded measurement slots cost
nothing numerically, and the loop ends when every lane is done.

The loop state (u, r, p, rz, the live lanes and the any-lane-live flag) lives
in tensors that one iteration, :func:`pcg`'s ``step``, updates in place. The
JAX package runs the whole loop as one compiled ``lax.while_loop``; here the
host reads the flag back once per iteration, so the iteration count equals the
JAX package's exactly. On the CPU each iteration runs op by op. On a CUDA
device (with :data:`GRAPHS`) the first iteration runs op by op as the warm-up,
the step is then captured once in a CUDA graph, and every later iteration is
one replay of it: the host launches one graph instead of each of the
iteration's operations. The graph runs the same operations in the same order
on the same addresses, so its iterates are those of the op-by-op loop.

A graph is captured on a stream other than the default one, so on a CUDA
device :func:`pcg` runs on the device's solve stream (:func:`solve_stream`).
A caller that enters that stream for a whole chunk (the executor does: its
assembly, factors and solve) keeps the chunk's memory in one stream's cache of
the allocator, since the allocator reuses a freed block only on the stream
that allocated it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from .. import kernels
from .stencil import stencil_apply, stencil_diag

# On CUDA tensors, run every iteration after the first as a replay of one
# captured CUDA graph. False runs them op by op, as on the CPU: the plain
# version that chip_smoke.py holds the graphed solves against.
GRAPHS = True

_SOLVE_STREAMS: dict[int, torch.cuda.Stream] = {}  # device index -> its solve stream


@contextlib.contextmanager
def solve_stream(device: torch.device):
    """Run the block on ``device``'s solve stream: one non-default stream per
    CUDA device, made at first use. Entering from another stream, the solve
    stream first waits for the work queued on that one, and that stream waits
    for the block's work when it ends; entered on the solve stream itself, or
    on the CPU, it changes nothing."""
    if device.type != "cuda":
        yield
        return
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SOLVE_STREAMS:
        _SOLVE_STREAMS[index] = torch.cuda.Stream(device=index)
    stream = _SOLVE_STREAMS[index]
    current = torch.cuda.current_stream(index)
    if current == stream:
        yield
        return
    stream.wait_stream(current)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        current.wait_stream(stream)


def _run_graphed(step: Callable[[], None], live: torch.Tensor, maxiter: int) -> dict:
    """The iterations of :func:`pcg` on a CUDA device, on the current stream
    (the solve stream): the first op by op (it builds the kernels at first use
    and creates the stream's cuBLAS workspace and any other state made lazily,
    outside the capture), then one capture of ``step`` and a replay per further
    iteration while ``live`` (the flag, read once per iteration) holds. The
    graph and its memory pool (this call's alone) are freed before returning,
    so a log of many chunks holds one at a time. A capture that fails raises.
    Returns the iterations, the capture's seconds and the replays."""
    k, replays, capture_s = 0, 0, 0.0
    if k < maxiter and bool(live):
        step()
        k += 1
    if not (k < maxiter and bool(live)):
        return {"iterations": k, "capture_seconds": capture_s, "replays": replays}
    counted = list(kernels.COUNTED)
    before = [m.CAPTURED for m in counted]
    t0 = time.perf_counter()
    pool = torch.cuda.MemPool()
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool.id, capture_error_mode="thread_local")
    try:
        step()
    except BaseException:
        with contextlib.suppress(RuntimeError):  # ends the broken capture
            graph.capture_end()
        raise
    graph.capture_end()
    capture_s = time.perf_counter() - t0
    per_replay = [m.CAPTURED - n for m, n in zip(counted, before)]
    while k < maxiter and bool(live):
        graph.replay()
        for m, n in zip(counted, per_replay):
            m.LAUNCHES += n
        k += 1
        replays += 1
    torch.cuda.current_stream().synchronize()  # a loop cut at maxiter has not read the flag
    graph.reset()
    del pool  # the pool's last reference: its memory goes back to the card
    return {"iterations": k, "capture_seconds": capture_s, "replays": replays}


@torch.no_grad()
def pcg(
    C: torch.Tensor | None,
    b: torch.Tensor,
    M_inv: Callable[[torch.Tensor], torch.Tensor] | None = None,
    tol: float = 1e-7,
    maxiter: int = 1000,
    n_grid_axes: int = 2,
    matvec: Callable[[torch.Tensor], torch.Tensor] | None = None,
):
    """Solve A u = b with A given by stencil C, for batched right-hand sides.

    C (..., NZ, NR, 3, 3), b (..., [S,] NZ, NR); or a custom ``matvec`` and
    ``M_inv``. Returns (u, info); info = dict(iterations (int), rel_residual
    of b's batch shape, capture_seconds, replays), the last two those of the
    CUDA graph (0 when the loop ran op by op). ``matvec`` and ``M_inv`` must
    not read the device from the host. Records no autograd graph: a
    differentiable solve is :mod:`remo3d_tpu_torch.ops.linear_solve`.
    """
    axes = tuple(range(-n_grid_axes, 0))

    def _dot(a, c):
        return torch.sum(a * c, dim=axes)

    if matvec is None:
        matvec = lambda u: stencil_apply(C, u)  # noqa: E731

    if M_inv is None:
        diag = stencil_diag(C)
        if b.ndim == C.ndim - n_grid_axes + 1:  # solve axis present
            diag = diag.unsqueeze(-(n_grid_axes + 1))
        safe_diag = torch.where(diag != 0, diag, torch.ones_like(diag))
        M_inv = lambda r: r / safe_diag  # noqa: E731

    def _bc(s):  # broadcast a batch scalar over the grid axes
        return s[(...,) + (None,) * n_grid_axes]

    with solve_stream(b.device):
        b_norm2 = _dot(b, b)
        active0 = b_norm2 > 0
        ones = torch.ones_like(b_norm2)
        tol2 = (tol * tol) * torch.where(active0, b_norm2, ones)

        u = torch.zeros_like(b)
        r = b.clone()
        p = M_inv(r).clone()
        rz = _dot(r, p)
        not_done = active0 & (_dot(r, r) > tol2)
        live = not_done.any()

        def step():
            """One iteration, in place. Each update is the JAX package's
            expression rounded the same way (``u + alpha*p`` as a product, then a
            sum: no fused multiply-add)."""
            Ap = matvec(p)
            pAp = _dot(p, Ap)
            lane = not_done & (pAp > 0)
            alpha = torch.where(lane, rz / torch.where(pAp > 0, pAp, ones), 0.0)
            u.add_(_bc(alpha) * p)
            r.sub_(_bc(alpha) * Ap)
            z = M_inv(r)
            rz_new = _dot(r, z)
            beta = torch.where(lane, rz_new / torch.where(rz > 0, rz, ones), 0.0)
            p.mul_(_bc(beta)).add_(z)  # z + beta*p
            # Freeze rz on finished lanes so their (masked) updates stay benign.
            rz.copy_(torch.where(lane, rz_new, rz))
            not_done.copy_(active0 & (_dot(r, r) > tol2))
            live.copy_(not_done.any())

        if b.device.type == "cuda" and GRAPHS:
            run = _run_graphed(step, live, maxiter)
        else:
            k = 0
            while k < maxiter and bool(live):
                step()
                k += 1
            run = {"iterations": k, "capture_seconds": 0.0, "replays": 0}
        rel = torch.sqrt(_dot(r, r) / torch.where(active0, b_norm2, ones))
        return u, {**run, "rel_residual": rel}
