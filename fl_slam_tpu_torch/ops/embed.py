"""Embed small-block Gaussian factors into the 22D chart (port of
``fl_slam_tpu/ops/embed.py``)."""

from __future__ import annotations

import torch

from fl_slam_tpu_torch.config import D_Z


def evidence_from_block(block: slice, L_small, h_small):
    """(L22, h22) with one diagonal block factor installed."""
    L = L_small.new_zeros((D_Z, D_Z))
    h = L_small.new_zeros((D_Z,))
    L[block, block] = L_small
    h[block] = h_small
    return L, h


def evidence_from_scalar(idx: int, precision: float, residual):
    L = residual.new_zeros((D_Z, D_Z))
    h = residual.new_zeros((D_Z,))
    # A device-side fill: writing a Python float into one element of a
    # CUDA tensor is a host-to-device copy that synchronizes.
    L[idx, idx] = torch.full_like(residual, precision)
    h[idx] = precision * residual
    return L, h
