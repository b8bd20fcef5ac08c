"""K3, the log-domain unbalanced Sinkhorn fixed point (port of the TPU
kernel ``fl_slam_tpu/ops/assoc_kernels.py:77`` ``sinkhorn_piT``).

``sinkhorn_piT`` is a ``torch.library.custom_op``: it launches the
hand-written CUDA kernel (``csrc/sinkhorn.cu``, the Pallas kernel's
finite-cap form) for CUDA tensors and runs the plain version
(``sinkhorn_piT_plain``, the reference's XLA form with -inf rows) for CPU
tensors; any other device, or a shape the kernel cannot hold on one SM,
raises. Its instance-batching rule (``register_vmap``) launches the kernel
once for all instances under ``torch.func.vmap``, one block each (the
reference gets that batching from its grid). ``launches`` counts kernel
launches, one-instance and batched apart.
"""

from __future__ import annotations

import ctypes

import torch

from fl_slam_tpu_torch import cuda_build
from fl_slam_tpu_torch.runtime import instance_first

_NEG_CAP = -1e30
_LOG_ZERO = -3e38
_MAX_SMEM = 227 * 1024 - 8 * 1024     # dynamic smem left beside the static
launches = {"sinkhorn_piT": 0, "sinkhorn_piT_batched": 0}


def sinkhorn_piT_plain(logKT, log_a, *, n_iter: int, ua: float, vb: float,
                       log_b: float):
    """Plain PyTorch version: ``n_iter`` column/row logsumexp passes over
    logKT (K, N); rows with log_a = -inf transport zero."""
    K = logKT.shape[0]
    finite_a = torch.isfinite(log_a)
    log_u = torch.zeros_like(log_a)
    log_v = torch.zeros((K,), dtype=logKT.dtype, device=logKT.device)
    lb = torch.full((K,), log_b, dtype=logKT.dtype, device=logKT.device)
    for _ in range(n_iter):
        lse_v = torch.logsumexp(logKT + log_v[:, None], 0)
        log_u = ua * (log_a - torch.clamp(lse_v, min=_NEG_CAP))
        log_u = torch.where(finite_a, log_u, float("-inf"))
        lse_u = torch.logsumexp(logKT + log_u[None, :], 1)
        log_v = vb * (lb - torch.clamp(lse_u, min=_NEG_CAP))
    log_pi = log_u[None, :] + logKT + log_v[:, None]
    return torch.where(torch.isfinite(log_pi), torch.exp(log_pi), 0.0)


def _launch(logKT, log_a, *, n_iter: int, ua: float, vb: float,
            log_b: float, key: str):
    """The kernel on (B, K, N) ``logKT`` and (B, N) ``log_a``: one block per
    instance."""
    if logKT.device.type != "cuda":
        raise ValueError(f"sinkhorn_piT: unsupported device {logKT.device}")
    B, K, N = logKT.shape
    if tuple(log_a.shape) != (B, N) or log_a.device != logKT.device:
        raise ValueError(f"sinkhorn_piT: log_a {tuple(log_a.shape[1:])} does "
                         f"not match logKT {tuple(logKT.shape[1:])}")
    if logKT.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sinkhorn_piT: dtype {logKT.dtype}")
    smem = (K + 2) * N * logKT.element_size()
    if K > 32 or smem > _MAX_SMEM:
        raise ValueError(f"sinkhorn_piT: K={K}, N={N} needs {smem} B of "
                         f"shared memory (K <= 32 and <= {_MAX_SMEM} B)")
    logKT = logKT.contiguous()
    la = torch.nan_to_num(log_a.to(logKT.dtype), nan=_LOG_ZERO,
                          neginf=_LOG_ZERO, posinf=0.0).contiguous()
    piT = torch.empty_like(logKT)
    lib = cuda_build.library("sinkhorn")
    fn = lib.sinkhorn_f32 if logKT.dtype == torch.float32 else \
        lib.sinkhorn_f64
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_double] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(logKT.data_ptr(), la.data_ptr(), piT.data_ptr(), B, K, N,
            int(n_iter), float(ua), float(vb), float(log_b),
            cuda_build.stream_ptr(logKT.device))
    cuda_build.check(lib, rc, "sinkhorn_piT")
    launches[key] += 1
    return piT


@torch.library.custom_op("fl_slam::sinkhorn_piT", mutates_args=())
def _sinkhorn(logKT: torch.Tensor, log_a: torch.Tensor, n_iter: int,
              ua: float, vb: float, log_b: float) -> torch.Tensor:
    kw = dict(n_iter=n_iter, ua=ua, vb=vb, log_b=log_b)
    if logKT.device.type == "cpu":
        return sinkhorn_piT_plain(logKT, log_a, **kw)
    return _launch(logKT[None], log_a[None], key="sinkhorn_piT", **kw)[0]


@torch.library.register_vmap("fl_slam::sinkhorn_piT")
def _sinkhorn_vmap(info, in_dims, logKT, log_a, n_iter, ua, vb, log_b):
    B = info.batch_size
    lk = instance_first(B, logKT, in_dims[0])
    la = instance_first(B, log_a, in_dims[1])
    kw = dict(n_iter=n_iter, ua=ua, vb=vb, log_b=log_b)
    if lk.device.type == "cpu":
        return torch.stack([sinkhorn_piT_plain(lk[b], la[b], **kw)
                            for b in range(B)]), 0
    return _launch(lk, la, key="sinkhorn_piT_batched", **kw), 0


def sinkhorn_piT(logKT, log_a, *, n_iter: int, ua: float, vb: float,
                 log_b: float):
    """Transported-mass matrix piT (K, N) from potentials logKT = -C^T/eps
    and the source log-marginal log_a (N,) (-inf = invalid row). Under
    ``torch.func.vmap`` one launch serves every instance."""
    if logKT.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sinkhorn_piT: unsupported device {logKT.device}")
    return _sinkhorn(logKT, log_a, int(n_iter), float(ua), float(vb),
                     float(log_b))
