"""K4, the moment segment-sum ``out[f, c] = sum_n [cell_n == c] payload[f, n]``
(port of the TPU kernel ``fl_slam_tpu/ops/surfel_kernels.py:89``).

``moment_segment_sum`` is a ``torch.library.custom_op``: it launches the
hand-written CUDA kernel (``csrc/moment.cu``) for CUDA tensors and runs the
plain version (``moment_segment_sum_plain``) for CPU tensors; any other
device raises. It takes any shape: there is no alignment gate. Ids outside
[0, n_cells) drop. Its instance-batching rule (``register_vmap``) launches
the kernel once for all instances under ``torch.func.vmap``, with a grid
axis over them. The kernel is two launches on one stream (a sort-and-
reduce pass per span of ids, then a gather per cell; ``moment_plan`` sizes
them) and counts one: ``launches[site]`` per call site,
``launches[site + "_batched"]`` the batched ones.
"""

from __future__ import annotations


import torch

from fl_slam_tpu_torch import cuda_build
from fl_slam_tpu_torch.runtime import instance_first

launches = {"surfels": 0, "fuse": 0, "surfels_batched": 0,
            "fuse_batched": 0}
_MAX_F = 64               # payload rows the kernel takes
_MAX_SPAN = 256           # ids per span of the first pass (its threads)
_TILE = 128               # cells per block of the second pass


def moment_plan(F: int, N: int, C: int, itemsize: int) -> dict:
    """The launch plan of the kernel for one instance: the span S (ids per
    block of the first pass, a power of two, 32 <= S <= 256) is 256, cut to
    the next power of two >= N; Y spans cover the N ids. A block stages its
    payload and two key buffers, at most S (F itemsize + 16) bytes of shared
    memory (135 KB at F = 64 in f64, of the 227 KB a block may hold). The
    scratch between the passes is each span's distinct cells, their sums
    (F rounded up to 16 bytes) and the first run of each 128-cell tile:
    O(F N) bytes, and Y (C / 128 + 1) ints."""
    if not 1 <= F <= _MAX_F:
        raise ValueError(f"moment_segment_sum: {F} payload rows, the kernel "
                         f"takes 1 to {_MAX_F}")
    S = min(_MAX_SPAN, max(32, 1 << max(0, N - 1).bit_length()))
    Y = -(-N // S)
    vec = 16 // itemsize
    FP = -(-F // vec) * vec
    T1 = -(-C // _TILE) + 1
    return {"span": S, "spans": Y, "features_padded": FP, "tiles": T1,
            "smem_bytes": S * (F * itemsize + 16),
            "scratch_bytes": Y * (S * (FP * itemsize + 4) + 4 * T1)}


def moment_segment_sum_plain(payload, cell, n_cells: int):
    """Plain PyTorch version: a one-hot contraction in the working dtype."""
    onehot = (cell.to(torch.int64)[:, None]
              == torch.arange(n_cells, device=cell.device)[None, :])
    return payload @ onehot.to(payload.dtype)


def _launch(payload, cell, n_cells: int, key: str):
    """The kernel on (B, F, N) ``payload`` and (B, N) ``cell``: a grid axis
    over the instances."""
    if payload.device.type != "cuda":
        raise ValueError(f"moment_segment_sum: unsupported device "
                         f"{payload.device}")
    if payload.dim() != 3 or tuple(cell.shape) != (payload.shape[0],
                                                   payload.shape[2]):
        raise ValueError(f"moment_segment_sum: payload "
                         f"{tuple(payload.shape[1:])} and cell "
                         f"{tuple(cell.shape[1:])} do not match")
    if payload.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"moment_segment_sum: dtype {payload.dtype}")
    if cell.device != payload.device:
        raise ValueError("moment_segment_sum: payload and cell devices differ")
    B, F, N = payload.shape
    plan = moment_plan(F, N, n_cells, payload.element_size())
    S, Y = plan["span"], plan["spans"]
    payload = payload.contiguous()
    cell32 = cell.to(torch.int32).contiguous()
    dev = payload.device
    ucell = torch.empty((B, Y, S), dtype=torch.int32, device=dev)
    tile_lo = torch.empty((B, Y, plan["tiles"]), dtype=torch.int32,
                          device=dev)
    usum = torch.empty((B, Y, S, plan["features_padded"]),
                       dtype=payload.dtype, device=dev)
    out = torch.empty((B, F, n_cells), dtype=payload.dtype, device=dev)
    lib = cuda_build.library("moment")
    fn = lib.moment_f32 if payload.dtype == torch.float32 else lib.moment_f64
    cuda_build.launch(lib, fn, "moment_segment_sum", dev, payload.data_ptr(),
                      cell32.data_ptr(), ucell.data_ptr(), tile_lo.data_ptr(),
                      usum.data_ptr(), out.data_ptr(), B, F, N, n_cells, S)
    launches[key] += 1
    return out


@torch.library.custom_op("fl_slam::moment_segment_sum", mutates_args=())
def _moment(payload: torch.Tensor, cell: torch.Tensor, n_cells: int,
            site: str) -> torch.Tensor:
    if payload.device.type == "cpu":
        return moment_segment_sum_plain(payload, cell, n_cells)
    if payload.dim() != 2:
        raise ValueError(f"moment_segment_sum: payload "
                         f"{tuple(payload.shape)} is not (F, N)")
    return _launch(payload[None], cell[None], n_cells, site)[0]


@torch.library.register_vmap("fl_slam::moment_segment_sum")
def _moment_vmap(info, in_dims, payload, cell, n_cells, site):
    B = info.batch_size
    pay = instance_first(B, payload, in_dims[0])
    ids = instance_first(B, cell, in_dims[1])
    if pay.device.type == "cpu":
        return torch.stack([moment_segment_sum_plain(pay[b], ids[b], n_cells)
                            for b in range(B)]), 0
    return _launch(pay, ids, n_cells, site + "_batched"), 0


def moment_segment_sum(payload, cell, n_cells: int, *, site: str):
    """payload (F, N) float, cell (N,) int -> (F, n_cells) per-cell sums.
    Under ``torch.func.vmap`` one launch serves every instance."""
    if site not in ("surfels", "fuse"):
        raise ValueError(f"moment_segment_sum: unknown site {site!r}")
    if payload.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moment_segment_sum: unsupported device "
                         f"{payload.device}")
    return _moment(payload, cell, int(n_cells), site)
