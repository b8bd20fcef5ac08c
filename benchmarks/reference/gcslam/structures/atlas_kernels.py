"""The slab exchange and the page IO of the resident slabs in plain
PyTorch (the reference's XLA forms). Frozen from the port's plain
versions; no kernel, no custom op."""

from __future__ import annotations

import torch


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


conditional_slab_exchange_ff = conditional_slab_exchange_ff_plain
page_gather_ff = page_gather_ff_plain
page_writeback_ff = page_writeback_ff_plain
