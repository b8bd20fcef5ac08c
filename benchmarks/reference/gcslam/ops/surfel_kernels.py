"""The moment segment-sum ``out[f, c] = sum_n [cell_n == c] payload[f, n]``
in plain PyTorch (the reference's ``segment_sum``): ids outside
[0, n_cells) drop. No kernel, no custom op."""

from __future__ import annotations

import torch


def moment_segment_sum(payload, cell, n_cells: int, *, site: str):
    """payload (F, N) float, cell (N,) int -> (F, n_cells) per-cell sums."""
    if site not in ("surfels", "fuse"):
        raise ValueError(f"moment_segment_sum: unknown site {site!r}")
    ids = cell.to(torch.int64)
    keep = (ids >= 0) & (ids < n_cells)
    out = torch.zeros((payload.shape[0], int(n_cells)), dtype=payload.dtype,
                      device=payload.device)
    return out.index_add_(1, torch.where(keep, ids, 0),
                          torch.where(keep[None, :], payload, 0.0))
