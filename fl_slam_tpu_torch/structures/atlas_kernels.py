"""K5, the conditional slab exchange on the resident col-major slabs (port
of the TPU kernel ``fl_slam_tpu/structures/atlas_kernels.py:353``
``conditional_slab_exchange_ff``).

If the device flag ``refresh`` is non-zero, flush the S resident blocks
``ff[:, s*M:(s+1)*M]`` / ``fp[s*M:(s+1)*M]`` into pool slots
``old_slots[s]``, then gather slots ``new_slots[s]`` back; otherwise do
nothing. In place; no host read of the flag. CUDA tensors launch the
hand-written kernel (``csrc/slab_exchange.cu``); CPU tensors run the plain
version (the reference's fallback, branch-free on the flag); any other
device raises. ``launches`` counts exchanges (each is two launches on one
stream: flush, then gather).
"""

from __future__ import annotations

import ctypes

import torch

from fl_slam_tpu_torch import cuda_build

launches = 0


def conditional_slab_exchange_ff_plain(pool_f, pool_p, ff, fp, old_slots,
                                       new_slots, refresh):
    """Plain PyTorch version (in place): the flush writes the old blocks
    where ``refresh`` is set, the gather reads the new slots back."""
    P, CF, M = pool_f.shape
    S = ff.shape[1] // M
    r = refresh.reshape(()) != 0
    old = old_slots.to(torch.int64)
    new = new_slots.to(torch.int64)
    slab_f = ff.view(CF, S, M).transpose(0, 1)
    slab_p = fp.view(S, M)
    pool_f[old] = torch.where(r, slab_f, pool_f[old])
    pool_p[old] = torch.where(r, slab_p, pool_p[old])
    slab_f.copy_(torch.where(r, pool_f[new], slab_f))
    slab_p.copy_(torch.where(r, pool_p[new], slab_p))
    return pool_f, pool_p, ff, fp


def conditional_slab_exchange_ff(pool_f, pool_p, ff, fp, old_slots,
                                 new_slots, refresh):
    """pool_f (P, CF, M), pool_p (P, M) int32, ff (CF, S*M), fp (S*M,)
    int32, slots (S,), refresh () int. Returns the same four tensors,
    updated in place."""
    if pool_f.device.type == "cpu":
        return conditional_slab_exchange_ff_plain(pool_f, pool_p, ff, fp,
                                                  old_slots, new_slots,
                                                  refresh)
    if pool_f.device.type != "cuda":
        raise ValueError(f"conditional_slab_exchange_ff: unsupported device "
                         f"{pool_f.device}")
    P, CF, M = pool_f.shape
    S = old_slots.shape[0]
    if (ff.shape != (CF, S * M) or fp.shape != (S * M,)
            or pool_p.shape != (P, M) or new_slots.shape != (S,)):
        raise ValueError("conditional_slab_exchange_ff: shapes do not match")
    if ff.dtype != pool_f.dtype or ff.dtype not in (torch.float32,
                                                    torch.float64):
        raise ValueError(f"conditional_slab_exchange_ff: dtype {ff.dtype}")
    if pool_p.dtype != torch.int32 or fp.dtype != torch.int32:
        raise ValueError("conditional_slab_exchange_ff: prim ids must be "
                         "int32")
    for t in (pool_f, pool_p, ff, fp):
        if not t.is_contiguous() or t.device != pool_f.device:
            raise ValueError("conditional_slab_exchange_ff: operands must be "
                             "contiguous and on one device")
    flag = refresh.reshape(1).to(torch.int32)
    olds = old_slots.to(torch.int32).contiguous()
    news = new_slots.to(torch.int32).contiguous()
    lib = cuda_build.library("slab_exchange")
    fn = lib.slab_exchange_f32 if ff.dtype == torch.float32 else \
        lib.slab_exchange_f64
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(flag.data_ptr(), olds.data_ptr(), news.data_ptr(),
            pool_f.data_ptr(), pool_p.data_ptr(), ff.data_ptr(),
            fp.data_ptr(), CF, M, S, cuda_build.stream_ptr(ff.device))
    cuda_build.check(lib, rc, "conditional_slab_exchange_ff")
    global launches
    launches += 1
    return pool_f, pool_p, ff, fp
