"""K4, the moment segment-sum ``out[f, c] = sum_n [cell_n == c] payload[f, n]``
(port of the TPU kernel ``fl_slam_tpu/ops/surfel_kernels.py:89``).

``moment_segment_sum`` launches the hand-written CUDA kernel
(``csrc/moment.cu``) for CUDA tensors and runs the plain version
(``moment_segment_sum_plain``) for CPU tensors; any other device raises.
It takes any shape: there is no alignment gate. Ids outside [0, n_cells)
drop. ``launches[site]`` counts kernel launches per call site.
"""

from __future__ import annotations

import ctypes

import torch

from fl_slam_tpu_torch import cuda_build

launches = {"surfels": 0, "fuse": 0}
_MAX_F = 64          # payload rows the kernel holds in registers
_SPAN = 1024         # ids per span of the first pass


def moment_segment_sum_plain(payload, cell, n_cells: int):
    """Plain PyTorch version: a one-hot contraction in the working dtype."""
    onehot = (cell.to(torch.int64)[:, None]
              == torch.arange(n_cells, device=cell.device)[None, :])
    return payload @ onehot.to(payload.dtype)


def moment_segment_sum(payload, cell, n_cells: int, *, site: str):
    """payload (F, N) float, cell (N,) int -> (F, n_cells) per-cell sums."""
    if payload.device.type == "cpu":
        return moment_segment_sum_plain(payload, cell, n_cells)
    if payload.device.type != "cuda":
        raise ValueError(f"moment_segment_sum: unsupported device "
                         f"{payload.device}")
    if payload.dim() != 2 or cell.shape != (payload.shape[1],):
        raise ValueError(f"moment_segment_sum: payload {tuple(payload.shape)}"
                         f" and cell {tuple(cell.shape)} do not match")
    if payload.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"moment_segment_sum: dtype {payload.dtype}")
    if cell.device != payload.device:
        raise ValueError("moment_segment_sum: payload and cell devices differ")
    F, N = payload.shape
    if F > _MAX_F:
        raise ValueError(f"moment_segment_sum: {F} payload rows > {_MAX_F}")
    payload = payload.contiguous()
    cell32 = cell.to(torch.int32).contiguous()
    Y = max(1, min(64, -(-N // _SPAN)))
    part = torch.empty((Y, F, n_cells), dtype=payload.dtype,
                       device=payload.device)
    out = torch.empty((F, n_cells), dtype=payload.dtype,
                      device=payload.device)
    lib = cuda_build.library("moment")
    fn = lib.moment_f32 if payload.dtype == torch.float32 else lib.moment_f64
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(payload.data_ptr(), cell32.data_ptr(), part.data_ptr(),
            out.data_ptr(), F, N, n_cells, Y,
            cuda_build.stream_ptr(payload.device))
    cuda_build.check(lib, rc, "moment_segment_sum")
    launches[site] += 1
    return out
