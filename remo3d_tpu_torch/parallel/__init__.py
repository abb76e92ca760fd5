# -*- coding: utf-8 -*-
"""Batched chunk executor (one CUDA device or the CPU)."""
