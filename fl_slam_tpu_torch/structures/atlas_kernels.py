"""The atlas kernels: K5 / K7 / K10, the conditional slab exchange, and K6,
the page IO of the resident slabs (port of the TPU kernels of
``fl_slam_tpu/structures/atlas_kernels.py``).

- K5 ``conditional_slab_exchange_ff`` (``:353``): if the device flag
  ``refresh`` is non-zero, flush the S resident blocks
  ``ff[:, s*M:(s+1)*M]`` / ``fp[s*M:(s+1)*M]`` into pool slots
  ``old_slots[s]``, then gather slots ``new_slots[s]`` back; otherwise do
  nothing. In place; no host read of the flag. K7 (``:322``) is its
  instance-batched twin: under ``torch.func.vmap`` one launch serves every
  instance, each predicated on its own flag.
- K10 ``conditional_slab_exchange`` (``:381``, batched ``:138``): the same
  exchange on row-major slabs (S, CF, M) / (S, M). The pipeline does not
  call it.
- K6 ``page_gather_ff`` / ``page_writeback_ff`` (``:554`` / ``:568``): the
  S contiguous (CF, P) column blocks of ``ff`` at device offsets (int32 or
  int64, read as they are), gathered, or written back in place; the
  dense-page insert runs them.

Each is a ``torch.library.custom_op`` with an instance-batching rule
(``register_vmap``): CUDA tensors launch the hand-written kernel
(``csrc/slab_exchange.cu``, ``csrc/page_io.cu``) once for one instance or
for all B; CPU tensors run the plain version (per instance under vmap); any
other device raises. ``launches`` counts kernel launches per kernel; an
exchange is one launch that flushes and gathers in one pass.
"""

from __future__ import annotations

import torch

from fl_slam_tpu_torch import cuda_build
from fl_slam_tpu_torch.runtime import instance_first

launches = {"exchange_ff": 0, "exchange_ff_batched": 0, "exchange": 0,
            "exchange_batched": 0, "page_gather": 0, "page_writeback": 0}


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the oracle on the card).
# ---------------------------------------------------------------------------


def conditional_slab_exchange_plain(pool_f, pool_p, slab_f, slab_p,
                                    old_slots, new_slots, refresh):
    """Plain PyTorch version of K10 (in place; ``slab_f`` (S, CF, M) and
    ``slab_p`` (S, M) may be views): the flush writes the old blocks where
    ``refresh`` is set, the gather reads the new slots back."""
    r = refresh.reshape(()) != 0
    old = old_slots.to(torch.int64)
    new = new_slots.to(torch.int64)
    pool_f[old] = torch.where(r, slab_f, pool_f[old])
    pool_p[old] = torch.where(r, slab_p, pool_p[old])
    slab_f.copy_(torch.where(r, pool_f[new], slab_f))
    slab_p.copy_(torch.where(r, pool_p[new], slab_p))
    return pool_f, pool_p, slab_f, slab_p


def conditional_slab_exchange_ff_plain(pool_f, pool_p, ff, fp, old_slots,
                                       new_slots, refresh):
    """Plain PyTorch version of K5 (in place): K10's on the (S, CF, M) view
    of the resident col-major slabs."""
    P, CF, M = pool_f.shape
    S = ff.shape[1] // M
    conditional_slab_exchange_plain(pool_f, pool_p,
                                    ff.view(CF, S, M).transpose(0, 1),
                                    fp.view(S, M), old_slots, new_slots,
                                    refresh)
    return pool_f, pool_p, ff, fp


def _page_cols(offs, P: int):
    return (offs.to(torch.int64)[:, None]
            + torch.arange(P, device=offs.device)).reshape(-1)


def page_gather_ff_plain(ff, offs, P: int):
    """Plain PyTorch version of the K6 gather: (CF, S*P) columns
    ``offs[s] + p`` of ``ff`` (CF, SM)."""
    return ff[:, _page_cols(offs, P)]


def page_writeback_ff_plain(ff, offs, upd, P: int):
    """Plain PyTorch version of the K6 write-back (in place)."""
    ff[:, _page_cols(offs, P)] = upd
    return ff


# ---------------------------------------------------------------------------
# Launches: every operand carries a leading instance axis of length B.
# ---------------------------------------------------------------------------


def _check_exchange(pool_f, pool_p, slab_f, slab_p, old_slots, new_slots,
                    refresh, row_major: bool):
    """Operands with a leading instance axis; raises on what the kernel
    does not take. Returns (B, P, CF, M, S)."""
    name = ("conditional_slab_exchange" if row_major
            else "conditional_slab_exchange_ff")
    if pool_f.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pool_f.device}")
    B, P, CF, M = pool_f.shape
    S = old_slots.shape[1]
    want = ((B, S, CF, M) if row_major else (B, CF, S * M),
            (B, S, M) if row_major else (B, S * M))
    if (tuple(slab_f.shape) != want[0] or tuple(slab_p.shape) != want[1]
            or tuple(pool_p.shape) != (B, P, M)
            or tuple(new_slots.shape) != (B, S)
            or tuple(refresh.shape) != (B,)):
        raise ValueError(f"{name}: shapes do not match")
    if slab_f.dtype != pool_f.dtype or slab_f.dtype not in (torch.float32,
                                                            torch.float64):
        raise ValueError(f"{name}: dtype {slab_f.dtype}")
    if pool_p.dtype != torch.int32 or slab_p.dtype != torch.int32:
        raise ValueError(f"{name}: prim ids must be int32")
    for t in (pool_f, pool_p, slab_f, slab_p):
        if not t.is_contiguous() or t.device != pool_f.device:
            raise ValueError(f"{name}: the pool and slabs must be contiguous "
                             "with the instance axis first, on one device")
    return B, P, CF, M, S


def _launch_exchange(pool_f, pool_p, slab_f, slab_p, old_slots, new_slots,
                     refresh, *, row_major: bool, key: str):
    B, P, CF, M, S = _check_exchange(pool_f, pool_p, slab_f, slab_p,
                                     old_slots, new_slots, refresh, row_major)
    flag = refresh.to(torch.int32).contiguous()
    olds = old_slots.to(torch.int32).contiguous()
    news = new_slots.to(torch.int32).contiguous()
    lib = cuda_build.library("slab_exchange")
    fn = lib.slab_exchange_f32 if slab_f.dtype == torch.float32 else \
        lib.slab_exchange_f64
    cuda_build.launch(lib, fn, key, pool_f.device, flag.data_ptr(),
                      olds.data_ptr(), news.data_ptr(), pool_f.data_ptr(),
                      pool_p.data_ptr(), slab_f.data_ptr(), slab_p.data_ptr(),
                      B, P, CF, M, S, int(row_major))
    launches[key] += 1


def page_launch_args(name: str, ff, offs, page, P: int) -> tuple:
    """K6's C arguments but the stream for (B, CF, SM) ``ff``, (B, S)
    ``offs`` and (B, CF, S*P) ``page``: the offsets are read as the caller
    made them (int32 or int64, flagged; no cast launch), with their instance
    stride (0 where one set is shared, as ``vmap`` broadcasts it). Raises on
    what the kernel does not take."""
    B, CF, SM = ff.shape
    S = offs.shape[1]
    if (offs.shape[0] != B or page.shape != (B, CF, S * P)
            or page.dtype != ff.dtype or page.device != ff.device
            or offs.device != ff.device):
        raise ValueError(f"{name}: shapes do not match")
    if ff.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: dtype {ff.dtype}")
    if offs.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: offsets {offs.dtype}")
    if not (ff.is_contiguous() and page.is_contiguous()):
        raise ValueError(f"{name}: ff and the page block must be contiguous "
                         "with the instance axis first")
    if S > 1 and offs.stride(1) != 1:
        raise ValueError(f"{name}: the offsets must be contiguous along the "
                         "pages")
    return (offs.data_ptr(), int(offs.dtype == torch.int64),
            offs.stride(0) if B > 1 else 0, ff.data_ptr(), page.data_ptr(),
            B, CF, SM, S, P)


def _launch_page(kind: str, ff, offs, page, P: int):
    """K6 on (B, CF, SM) ``ff``, (B, S) ``offs`` and (B, CF, S*P) ``page``."""
    name = f"page_{kind}_ff"
    if ff.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ff.device}")
    if offs.shape[1] > 1 and offs.stride(1) != 1:
        offs = offs.contiguous()
    args = page_launch_args(name, ff, offs, page, P)
    lib = cuda_build.library("page_io")
    fn = getattr(lib, f"page_{kind}_"
                 + ("f32" if ff.dtype == torch.float32 else "f64"))
    cuda_build.launch(lib, fn, name, ff.device, *args)
    launches[f"page_{kind}"] += 1


def _batched_mutated(x, dim, name):
    if dim is None:
        raise ValueError(f"{name}: the operand it writes must carry the "
                         "instance axis under vmap")
    return x.movedim(dim, 0)


def _require_device(t, name):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# K5 / K7 and K10: the exchange ops and their instance-batching rules.
# ---------------------------------------------------------------------------


def _exchange_op(name: str, row_major: bool, plain):
    qual = f"fl_slam::{name}"

    @torch.library.custom_op(qual, mutates_args=("pool_f", "pool_p",
                                                 "slab_f", "slab_p"))
    def op(pool_f: torch.Tensor, pool_p: torch.Tensor, slab_f: torch.Tensor,
           slab_p: torch.Tensor, old_slots: torch.Tensor,
           new_slots: torch.Tensor, refresh: torch.Tensor) -> None:
        if pool_f.device.type == "cpu":
            plain(pool_f, pool_p, slab_f, slab_p, old_slots, new_slots,
                  refresh)
            return
        _launch_exchange(pool_f[None], pool_p[None], slab_f[None],
                         slab_p[None], old_slots[None], new_slots[None],
                         refresh.reshape(1), row_major=row_major,
                         key="exchange" if row_major else "exchange_ff")

    @torch.library.register_vmap(qual)
    def op_vmap(info, in_dims, pool_f, pool_p, slab_f, slab_p, old_slots,
                new_slots, refresh):
        B = info.batch_size
        pf, pp, sf, sp = [_batched_mutated(x, d, name) for x, d in zip(
            (pool_f, pool_p, slab_f, slab_p), in_dims[:4])]
        olds, news = (instance_first(B, x, d) for x, d in zip(
            (old_slots, new_slots), in_dims[4:6]))
        flag = instance_first(B, refresh, in_dims[6]).reshape(B)
        if pf.device.type == "cpu":
            for b in range(B):
                plain(pf[b], pp[b], sf[b], sp[b], olds[b], news[b], flag[b])
        else:
            _launch_exchange(pf, pp, sf, sp, olds, news, flag,
                             row_major=row_major,
                             key=("exchange_batched" if row_major
                                  else "exchange_ff_batched"))
        return None, None

    return op


_exchange_ff = _exchange_op("slab_exchange_ff", False,
                            conditional_slab_exchange_ff_plain)
_exchange_rows = _exchange_op("slab_exchange", True,
                              conditional_slab_exchange_plain)


def conditional_slab_exchange_ff(pool_f, pool_p, ff, fp, old_slots,
                                 new_slots, refresh):
    """K5 (K7 under vmap). pool_f (P, CF, M), pool_p (P, M) int32, ff (CF,
    S*M), fp (S*M,) int32, slots (S,), refresh () int. Returns the same four
    tensors, updated in place."""
    _require_device(pool_f, "conditional_slab_exchange_ff")
    _exchange_ff(pool_f, pool_p, ff, fp, old_slots, new_slots, refresh)
    return pool_f, pool_p, ff, fp


def conditional_slab_exchange(pool_f, pool_p, slab_f, slab_p, old_slots,
                              new_slots, refresh):
    """K10 (batched under vmap): the exchange on row-major slabs slab_f (S,
    CF, M), slab_p (S, M) int32. Returns the four tensors, updated in
    place."""
    _require_device(pool_f, "conditional_slab_exchange")
    _exchange_rows(pool_f, pool_p, slab_f, slab_p, old_slots, new_slots,
                   refresh)
    return pool_f, pool_p, slab_f, slab_p


# ---------------------------------------------------------------------------
# K6: page gather / write-back ops and their instance-batching rules.
# ---------------------------------------------------------------------------


@torch.library.custom_op("fl_slam::page_gather_ff", mutates_args=())
def _page_gather(ff: torch.Tensor, offs: torch.Tensor,
                 P: int) -> torch.Tensor:
    if ff.device.type == "cpu":
        return page_gather_ff_plain(ff, offs, P)
    CF = ff.shape[0]
    page = torch.empty((1, CF, offs.shape[0] * P), dtype=ff.dtype,
                       device=ff.device)
    _launch_page("gather", ff[None], offs[None], page, P)
    return page[0]


@torch.library.register_vmap("fl_slam::page_gather_ff")
def _page_gather_vmap(info, in_dims, ff, offs, P):
    B = info.batch_size
    ffb = instance_first(B, ff, in_dims[0])
    offb = instance_first(B, offs, in_dims[1])
    if ffb.device.type == "cpu":
        return torch.stack([page_gather_ff_plain(ffb[b], offb[b], P)
                            for b in range(B)]), 0
    ffb = ffb.contiguous()
    page = torch.empty((B, ffb.shape[1], offb.shape[1] * P), dtype=ffb.dtype,
                       device=ffb.device)
    _launch_page("gather", ffb, offb, page, P)
    return page, 0


@torch.library.custom_op("fl_slam::page_writeback_ff", mutates_args=("ff",))
def _page_writeback(ff: torch.Tensor, offs: torch.Tensor, upd: torch.Tensor,
                    P: int) -> None:
    if ff.device.type == "cpu":
        page_writeback_ff_plain(ff, offs, upd, P)
        return
    _launch_page("writeback", ff[None], offs[None],
                 upd.to(ff.dtype)[None].contiguous(), P)


@torch.library.register_vmap("fl_slam::page_writeback_ff")
def _page_writeback_vmap(info, in_dims, ff, offs, upd, P):
    B = info.batch_size
    ffb = _batched_mutated(ff, in_dims[0], "page_writeback_ff")
    offb = instance_first(B, offs, in_dims[1])
    updb = instance_first(B, upd, in_dims[2])
    if ffb.device.type == "cpu":
        for b in range(B):
            page_writeback_ff_plain(ffb[b], offb[b], updb[b], P)
    else:
        _launch_page("writeback", ffb, offb,
                     updb.to(ffb.dtype).contiguous(), P)
    return None, None


def page_gather_ff(ff, offs, P: int):
    """K6 gather: ff (CF, SM), offs (S,) int column starts -> (CF, S*P)
    (one launch for all instances under vmap)."""
    _require_device(ff, "page_gather_ff")
    return _page_gather(ff, offs, int(P))


def page_writeback_ff(ff, offs, upd, P: int):
    """K6 write-back, the inverse of ``page_gather_ff``: upd (CF, S*P) into
    ``ff`` at offs, in place. Returns ``ff``."""
    _require_device(ff, "page_writeback_ff")
    _page_writeback(ff, offs, upd, int(P))
    return ff
