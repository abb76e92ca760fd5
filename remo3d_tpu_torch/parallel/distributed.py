# -*- coding: utf-8 -*-
"""Multi-process runs over ``torch.distributed``.

The counterpart of ``remo3d_tpu.parallel.distributed``. The reference scales
across nodes with an MPI worker farm (remo3d.py:592, mpiexec in its examples);
here every process runs the same program, calls :func:`initialize_distributed`
once, and :class:`~remo3d_tpu_torch.parallel.runtime.Executor` splits each
chunk over the ranks: its batches on the batch axis, or its right-hand sides
on the solve axis when there are fewer batches than ranks. Each rank meshes
and stages its own share from the host, so only the readouts cross ranks,
gathered on the host at the end (:func:`gather_result`). That traffic is
small host arrays, so the process group is gloo on CPU tensors whatever the
ranks compute on, and several ranks may share one CUDA card (NCCL refuses two
ranks on one card).

Launch with ``torchrun --nproc-per-node N script.py`` (the script calls
``initialize_distributed()`` with no arguments and reads the environment
torchrun sets), or give the address, the world size and the rank explicitly.
Single-process runs are unaffected: every helper degrades to a no-op.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

# Set once this module has tried to initialize; a second call with no group up
# returns False instead of trying again.
_init_attempted = False

# What torchrun (and the env:// rendezvous) sets.
_CLUSTER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize a gloo process group for a multi-process run (idempotent).

    ``coordinator_address`` is "host:port" (or a ``tcp://`` URL) of rank 0,
    ``num_processes`` the world size and ``process_id`` this process's rank.
    With no arguments the environment torchrun sets is used (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE). Returns True when a process group is up,
    False for a plain single-process run.

    Failure policy, as in the JAX package: explicit arguments mean the caller
    expects a cluster, so errors re-raise; the no-argument form returns False,
    with a warning when cluster variables are set but the group cannot form.
    """
    global _init_attempted
    if dist.is_available() and dist.is_initialized():
        return True
    if _init_attempted:
        return False
    _init_attempted = True
    explicit = (
        coordinator_address is not None or num_processes is not None or process_id is not None
    )
    hints = [k for k in _CLUSTER_VARS if os.environ.get(k)]
    if not explicit and not hints:
        return False
    try:
        if not dist.is_available():
            raise RuntimeError("this torch build has no torch.distributed")
        if explicit:
            if None in (coordinator_address, num_processes, process_id):
                raise ValueError(
                    "initialize_distributed: give coordinator_address, num_processes and "
                    "process_id together"
                )
            url = coordinator_address
            if "://" not in url:
                url = f"tcp://{url}"
            dist.init_process_group(
                "gloo", init_method=url, world_size=int(num_processes), rank=int(process_id)
            )
        else:
            dist.init_process_group("gloo", init_method="env://")
        return True
    except Exception as e:
        if explicit:
            raise
        warnings.warn(
            f"torch.distributed.init_process_group failed ({type(e).__name__}: {e}) "
            f"despite cluster variables {hints}; running as a single process",
            RuntimeWarning,
            stacklevel=2,
        )
        return False


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_multiprocess() -> bool:
    return world()[1] > 1


def _all_gather(a: np.ndarray) -> list[np.ndarray]:
    t = torch.from_numpy(np.ascontiguousarray(a))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return [p.numpy() for p in parts]


def gather_result(x, owned: np.ndarray | None = None) -> np.ndarray:
    """Bring a result to every rank, as a host array.

    Without ``owned``: every rank's ``x`` concatenated along axis 0 (JAX's
    ``process_allgather(tiled=True)``); a single process gets ``x`` itself.
    With ``owned`` (a bool mask of ``x``'s shape): the merged array, where each
    position holds the value of the rank that owns it and, where no rank does,
    this rank's own ``x``. A position that its owner left NaN (a failed solve)
    stays NaN.
    """
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not is_multiprocess():
        return x.copy()
    values = _all_gather(x)
    if owned is None:
        return np.concatenate(values, axis=0)
    masks = _all_gather(np.asarray(owned, dtype=np.uint8))
    out = x.copy()
    for v, m in zip(values, masks):
        out[m.astype(bool)] = v[m.astype(bool)]
    return out


def sum_over_ranks(values: list[int]) -> list[int]:
    """Element-wise sum of small integer counters over the ranks."""
    if not is_multiprocess():
        return list(values)
    t = torch.tensor(values, dtype=torch.int64)
    dist.all_reduce(t)
    return [int(v) for v in t]
