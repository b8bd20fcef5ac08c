"""Embed small-block Gaussian factors into the 22D chart (port of
``fl_slam_tpu/ops/embed.py``).

The blocks are zero-padded out of place, not written into a zeros tensor:
under ``torch.func.vmap`` a fresh zeros tensor is unbatched and cannot take
a per-instance block in place. Padding with zeros is exact.
"""

from __future__ import annotations

import torch

from ..config import D_Z


def pad_block(rows: slice, cols: slice, B):
    """The (D_Z, D_Z) matrix with ``B`` at (rows, cols), zeros elsewhere."""
    return torch.nn.functional.pad(B, (cols.start, D_Z - cols.stop,
                                       rows.start, D_Z - rows.stop))


def pad_vec(block: slice, v):
    """The (D_Z,) vector with ``v`` at ``block``, zeros elsewhere."""
    return torch.nn.functional.pad(v, (block.start, D_Z - block.stop))


def evidence_from_block(block: slice, L_small, h_small):
    """(L22, h22) with one diagonal block factor installed."""
    return pad_block(block, block, L_small), pad_vec(block, h_small)


def evidence_from_scalar(idx: int, precision: float, residual):
    # A device-side fill: writing a Python float into one element of a
    # CUDA tensor is a host-to-device copy that synchronizes.
    sl = slice(idx, idx + 1)
    return (pad_block(sl, sl, torch.full_like(residual, precision)
                      .reshape(1, 1)),
            pad_vec(sl, (precision * residual).reshape(1)))
