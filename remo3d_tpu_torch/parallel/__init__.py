# -*- coding: utf-8 -*-
"""Batched chunk executor (one CUDA device or the CPU per process) and its
multi-process split over torch.distributed (``distributed``)."""

from .runtime import Executor, ExecutorConfig  # noqa: F401
