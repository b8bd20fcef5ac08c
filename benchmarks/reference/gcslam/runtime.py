"""Device resolution and small constants of the plain reference.

The reference never sets the matmul precision itself: its caller does
(``reference.replay.set_precision``), so that the same code runs as the
reference (f32, TF32 off) and as the lower-precision control (TF32 on)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; otherwise ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_CONSTS: dict = {}


def const(values, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A small constant tensor on ``like``'s device, cached per (values,
    dtype, device). Callers never mutate it."""
    dtype = like.dtype if dtype is None else dtype
    key = (tuple(values), dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(list(values), dtype=dtype).to(like.device,
                                                        non_blocking=True)
        _CONSTS[key] = t
    return t
