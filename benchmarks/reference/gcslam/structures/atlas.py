"""Atlas map as one fixed-shape device structure (port of
``fl_slam_tpu/structures/atlas.py``).

A fixed pool of ``n_tiles_pool`` tile slabs of ``m_tile`` primitive slots,
stored as one fused field block ``fdata (P, CF, M)`` plus an int64 tile-key
directory. The active tiles' slabs are resident in the scan carry in the
col-major form ``ff (CF, S*M)``; the view (paged, or per slot with
``view_page=0``), compact fuse / merge and the insert run on it. The
row-major slab API (``Slabs (S, CF, M)``, the ``slab_*`` ops and the
atlas-level wrappers) is the reference's standalone form of the same ops:
tests and one-off use, not the per-scan path.

Field layout along CF (fixed offsets; CF = 19 + 3B rounded up to 8):
  rows [0, 6) lam6 | [6, 9) theta | [9, 12) rgb_acc | 12 weights |
  13 cam_mass | 14 lidar_mass | 15 rgb_denom | 16 created_seq |
  17 last_supported | 18 valid | [19, 19+3B) eta | pad.

In-place updates: the pool and the resident slabs belong to the pipeline
state, and the scan update writes them in place where the reference's
functional update would copy them (the slab exchange, the view
write-back, the insert scatter). The row-major wrappers convert with a
copy, so they leave their input slabs as they were. Out-of-range targets of
a "drop" scatter are dropped, as the reference's ``mode="drop"`` scatters
drop them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GCConfig
from ..core.linalg import (det3x3, inv3x3, mat33_to_sym6,
                                           sym6_to_mat33, top_k,
                                           top_k_maybe_approx)
from ..ops import surfel_kernels
from ..runtime import const
from ..structures import atlas_kernels
from ..structures.measurement_batch import MeasurementBatch

EMPTY_KEY = -1
_O_SCAL = 12
_ROW_W, _ROW_CM, _ROW_LM, _ROW_RD, _ROW_CS, _ROW_LS, _ROW_V = range(7)
_O_ETA = 19


def _cf_padded(n_lobes: int) -> int:
    return ((_O_ETA + 3 * n_lobes + 7) // 8) * 8


class AtlasMap(NamedTuple):
    """Fixed-pool tile atlas: ``tile_keys (P,)`` int64 (-1 free),
    ``tile_touch_seq (P,)`` int32, ``fdata (P, CF, M)``, ``prim_ids (P, M)``
    int32 (-1 empty), ``next_prim_id ()`` int32."""

    tile_keys: torch.Tensor
    tile_touch_seq: torch.Tensor
    fdata: torch.Tensor
    prim_ids: torch.Tensor
    next_prim_id: torch.Tensor


class SlabsFF(NamedTuple):
    """Resident working set: ``ff (CF, S*M)``, ``prim_ids (S*M,)``."""

    ff: torch.Tensor
    prim_ids: torch.Tensor
    next_prim_id: torch.Tensor


class MapView(NamedTuple):
    """Stitched candidate pool over the active slabs (V rows)."""

    positions: torch.Tensor       # (V, 3)
    Lambdas: torch.Tensor         # (V, 3, 3)
    directions: torch.Tensor      # (V, 3)
    kappas: torch.Tensor          # (V,)
    weights: torch.Tensor         # (V,)
    valid: torch.Tensor           # (V,) bool
    last_supported: torch.Tensor  # (V,) int32
    prim_ids: torch.Tensor        # (V,) int32
    slab_idx: torch.Tensor        # (V,) slab-flat index s*M + m
    packed: torch.Tensor          # (V, 19) fused candidate matrix
    raw: torch.Tensor             # (V, CF) gathered field rows
    put_idx: torch.Tensor         # (V,) write-back column; SM = dropped


def put_drop_(x, dim: int, idx, src):
    """In place ``x[idx] = src`` along ``dim`` where entries with
    ``idx >= x.shape[dim]`` are dropped (the kept targets are distinct).

    No host sync and no data-dependent shape: each entry writes the value
    its target ends with (the kept writer's row, else the current row), so
    repeated targets write identical values. Every write is out of place or
    into ``x``, so it runs under ``torch.func.vmap``."""
    n = x.shape[dim]
    idx = idx.to(torch.int64)
    E = idx.shape[0]
    dst = torch.where(idx < n, idx, n)
    inv = torch.full((n + 1,), -1, dtype=torch.int64,
                     device=x.device).scatter(0, dst,
                                              torch.arange(E, device=x.device))
    t = torch.clamp(idx, max=n - 1)
    w = inv.index_select(0, t)
    shape = [1] * x.dim()
    shape[dim] = E
    val = torch.where((w >= 0).reshape(shape),
                      src.index_select(dim, torch.clamp(w, min=0)),
                      x.index_select(dim, t))
    # index_put_ on the moved view: it has an instance-batching rule under
    # torch.func.vmap, where index_copy_ falls back to a loop.
    x.movedim(dim, 0).index_put_((t,), val.movedim(dim, 0))
    return x


def empty_atlas(cfg: GCConfig, device) -> AtlasMap:
    P, M = cfg.n_tiles_pool, cfg.m_tile
    cf = _cf_padded(cfg.vmf_n_lobes)
    fdata = torch.zeros((P, cf, M), dtype=cfg.torch_dtype, device=device)
    fdata[:, _O_SCAL + _ROW_CS] = -1.0
    fdata[:, _O_SCAL + _ROW_LS] = -1.0
    return AtlasMap(
        tile_keys=torch.full((P,), -1, dtype=torch.int64, device=device),
        tile_touch_seq=torch.full((P,), -1, dtype=torch.int32, device=device),
        fdata=fdata,
        prim_ids=torch.full((P, M), -1, dtype=torch.int32, device=device),
        next_prim_id=torch.zeros((), dtype=torch.int32, device=device))


class Slabs(NamedTuple):
    """Row-major active-tile working set: ``fdata (S, CF, M)``,
    ``prim_ids (S, M)``."""

    fdata: torch.Tensor
    prim_ids: torch.Tensor
    next_prim_id: torch.Tensor


def gather_slabs(atlas: AtlasMap, slots) -> Slabs:
    """The S active tiles' slabs, row-major (a copy)."""
    sl = slots.to(torch.int64)
    return Slabs(fdata=atlas.fdata[sl], prim_ids=atlas.prim_ids[sl],
                 next_prim_id=atlas.next_prim_id)


def scatter_slabs(atlas: AtlasMap, slots, sl: Slabs) -> AtlasMap:
    """Write row-major slabs back to their pool slots (in place)."""
    s = slots.to(torch.int64)
    atlas.fdata[s] = sl.fdata
    atlas.prim_ids[s] = sl.prim_ids
    return atlas._replace(next_prim_id=sl.next_prim_id)


def slabs_to_ff(sl: Slabs) -> SlabsFF:
    """The col-major form ``ff (CF, S*M)`` of row-major slabs (a copy)."""
    S, cf, M = sl.fdata.shape
    ff = sl.fdata.transpose(0, 1).clone(memory_format=torch.contiguous_format)
    return SlabsFF(ff=ff.reshape(cf, S * M),
                   prim_ids=sl.prim_ids.reshape(S * M).clone(),
                   next_prim_id=sl.next_prim_id)


def slabs_from_ff(sf: SlabsFF, S: int) -> Slabs:
    """The row-major view ``(S, CF, M)`` of col-major slabs (no copy)."""
    cf, SM = sf.ff.shape
    return Slabs(fdata=sf.ff.reshape(cf, S, SM // S).transpose(0, 1),
                 prim_ids=sf.prim_ids.reshape(S, SM // S),
                 next_prim_id=sf.next_prim_id)


def gather_slabs_ff(atlas: AtlasMap, slots) -> SlabsFF:
    return slabs_to_ff(gather_slabs(atlas, slots))


def scatter_slabs_ff(atlas: AtlasMap, slots, sf: SlabsFF) -> AtlasMap:
    """Write the resident slabs back to their pool slots (in place)."""
    return scatter_slabs(atlas, slots, slabs_from_ff(sf, slots.shape[0]))


def activate_tiles(atlas: AtlasMap, keys, scan_seq):
    """Resolve S active tile keys to pool slots, allocating missing tiles
    (free slots first, then the least recently active, lowest index).
    Returns (atlas', slots (S,) int32, fresh (S,) bool, certs)."""
    P = atlas.tile_keys.shape[0]
    dt = atlas.fdata.dtype
    eq = keys[:, None] == atlas.tile_keys[None, :]
    found = torch.any(eq, 1)
    slot_found = torch.argmax(eq.to(torch.int32), 1)
    matched_now = torch.any(eq, 0)
    is_free = atlas.tile_keys == EMPTY_KEY
    prio = torch.where(matched_now, 2 ** 30,
                       torch.where(is_free, -(2 ** 30),
                                   atlas.tile_touch_seq))
    order = torch.argsort(prio, stable=True)
    missing = ~found
    rank = torch.cumsum(missing.to(torch.int64), 0) - 1
    slot_alloc = order[torch.clamp(rank, 0, P - 1)]
    slots = torch.where(missing, slot_alloc, slot_found)
    n_evicted = torch.sum(missing & ~is_free[slots])
    tile_keys = atlas.tile_keys.index_put((slots,), keys)
    touch = atlas.tile_touch_seq.index_put(
        (slots,), scan_seq.to(torch.int32).expand(slots.shape))
    certs = {"atlas.tiles_allocated": torch.sum(missing).to(dt),
             "atlas.tiles_evicted": n_evicted.to(dt)}
    return (atlas._replace(tile_keys=tile_keys, tile_touch_seq=touch),
            slots.to(torch.int32), missing, certs)


def ff_inflate_and_clear(sf: SlabsFF, fresh, scan_seq, cfg: GCConfig, *,
                         gamma_power: int = 1):
    """ONE fused pass ``ff * A + B``: fresh-slab clear, recency inflation
    (mean-preserving), forgetting (gamma^R for a chunk of R scans) and the
    weight-threshold cull."""
    ff = sf.ff
    dt = ff.dtype
    cf, SM = ff.shape
    S = fresh.shape[0]
    M = SM // S
    o = _O_SCAL
    seqf = scan_seq.to(dt)
    fresh_c = fresh[:, None].expand(S, M).reshape(-1)
    vmask = (ff[o + _ROW_V] > 0.5) & ~fresh_c
    ds = torch.clamp(seqf - ff[o + _ROW_LS], min=0.0)
    decay = torch.clamp(torch.exp(-cfg.recency_decay_lambda * ds),
                        cfg.recency_min_scale, 1.0)
    decay = torch.where(vmask, decay, 1.0)
    gamma = cfg.forgetting_factor ** gamma_power
    w_new = ff[o + _ROW_W] * gamma
    below = vmask & (w_new < cfg.cull_weight_threshold)
    w_scale = torch.where(below | fresh_c, 0.0, torch.full_like(w_new, gamma))
    v_scale = torch.where(below | fresh_c, 0.0, torch.ones_like(w_new))
    row = torch.arange(cf, device=ff.device)[:, None]
    A = torch.where(row < 9, decay[None, :], 1.0)
    A = torch.where(row == o + _ROW_W, w_scale[None, :], A)
    A = torch.where(row == o + _ROW_V, v_scale[None, :], A)
    ls_fresh = (row == o + _ROW_LS) & fresh_c[None, :]
    A = torch.where(ls_fresh, 0.0, A)
    B = torch.where(ls_fresh, -1.0, torch.zeros((), dtype=dt, device=ff.device))
    n_valid = torch.clamp(torch.sum(vmask.to(dt)), min=1.0)
    certs = {
        "map.staleness_downscale_total": torch.sum((1.0 - decay) * vmask),
        "map.staleness_strength": torch.sum((1.0 - decay) * vmask) / n_valid,
        "map.culled_count": torch.sum(below.to(dt)),
        "map.culled_mass": torch.sum(w_new * below.to(dt)),
    }
    return sf._replace(ff=ff * A + B), certs


def slab_clear_fresh(sl: Slabs, fresh) -> Slabs:
    """Clear freshly allocated slabs: weights 0, last_supported -1, valid 0
    (standalone; the pipeline folds the clear into the dense pass)."""
    o = _O_SCAL
    m = fresh[:, None]
    fd = sl.fdata.clone()
    fd[:, o + _ROW_W] = torch.where(m, 0.0, fd[:, o + _ROW_W])
    fd[:, o + _ROW_LS] = torch.where(m, -1.0, fd[:, o + _ROW_LS])
    fd[:, o + _ROW_V] = torch.where(m, 0.0, fd[:, o + _ROW_V])
    return sl._replace(fdata=fd)


def slab_inflate_and_clear(sl: Slabs, fresh, scan_seq, cfg: GCConfig):
    """Fresh-slab clear and recency inflation (mean-preserving) on
    row-major slabs, as one pass ``fdata * A + B``."""
    fd = sl.fdata
    dt = fd.dtype
    S, cf, M = fd.shape
    o = _O_SCAL
    seqf = torch.as_tensor(scan_seq, dtype=dt, device=fd.device)
    vmask = (fd[:, o + _ROW_V] > 0.5) & ~fresh[:, None]
    ds = torch.clamp(seqf - fd[:, o + _ROW_LS], min=0.0)
    decay = torch.clamp(torch.exp(-cfg.recency_decay_lambda * ds),
                        cfg.recency_min_scale, 1.0)
    decay = torch.where(vmask, decay, 1.0)
    row = torch.arange(cf, device=fd.device)[None, :, None]
    is_clear = ((row == o + _ROW_W) | (row == o + _ROW_LS)
                | (row == o + _ROW_V))
    fr = fresh[:, None, None]
    A = torch.where(row < 9, decay[:, None, :], 1.0)
    A = torch.where(is_clear & fr, 0.0, A)
    B = torch.where((row == o + _ROW_LS) & fr, -1.0,
                    torch.zeros((), dtype=dt, device=fd.device))
    n_valid = torch.clamp(torch.sum(vmask.to(dt)), min=1.0)
    certs = {
        "map.staleness_downscale_total": torch.sum((1.0 - decay) * vmask),
        "map.staleness_strength": torch.sum((1.0 - decay) * vmask) / n_valid,
    }
    return sl._replace(fdata=fd * A + B), certs


def slab_recency_inflate(sl: Slabs, scan_seq, cfg: GCConfig):
    """Recency inflation alone (no fresh slab)."""
    fresh = torch.zeros((sl.fdata.shape[0],), dtype=torch.bool,
                        device=sl.fdata.device)
    return slab_inflate_and_clear(sl, fresh, scan_seq, cfg)


def ff_select_view_cols(sf: SlabsFF, S: int, cfg: GCConfig):
    """Per-slot view membership (``view_page=0``): per tile, half of the
    ``m_tile_view`` rows are the top slots by weight and half the most
    recently created, deduplicated (a recency copy of a weight-half slot
    is flagged and dropped on write-back). Invalid slots score a sentinel
    rising with the slot index, in the working dtype, so the pad rows of a
    sparse tile sit in its top slots, away from the insert's eviction
    choices. Returns (slab_cols (V,) int32, dup (V,) bool)."""
    ff = sf.ff
    cf, SM = ff.shape
    M = SM // S
    o = _O_SCAL
    V = cfg.m_tile_view
    dev = ff.device
    vmask2 = (ff[o + _ROW_V] > 0.5).reshape(S, M)
    kw = min(V - V // 2, M)
    kr = min(V // 2, M)
    inv_score = (-1e30 + 1e24 * torch.arange(M, dtype=ff.dtype,
                                             device=dev))[None, :]
    score_w = torch.where(vmask2, ff[o + _ROW_W].reshape(S, M), inv_score)
    score_r = torch.where(vmask2, ff[o + _ROW_CS].reshape(S, M), inv_score)
    _, idx_w = top_k_maybe_approx(score_w, kw, cfg.approx_topk)
    _, idx_r = top_k_maybe_approx(score_r, kr, cfg.approx_topk)
    dup_r = torch.any(idx_r[:, :, None] == idx_w[:, None, :], 2)
    dup = torch.cat([torch.zeros((S, kw), dtype=torch.bool, device=dev),
                     dup_r], 1)
    idx = torch.cat([idx_w, idx_r], 1)
    if idx.shape[1] < V:
        pad = V - idx.shape[1]
        idx = torch.nn.functional.pad(idx, (0, pad))
        dup = torch.nn.functional.pad(dup, (0, pad), value=True)
    slab_cols = torch.arange(S, device=dev)[:, None] * M + idx
    return slab_cols.reshape(-1).to(torch.int32), dup.reshape(-1)


def ff_extract_view(sf: SlabsFF, S: int, cfg: GCConfig) -> MapView:
    """Per-slot membership, one column gather, and the view derived from
    the gathered rows."""
    slab_cols, dup_f = ff_select_view_cols(sf, S, cfg)
    cols = slab_cols.to(torch.int64)
    return view_from_rows(sf.ff[:, cols].T, slab_cols, dup_f,
                          sf.prim_ids[cols], sf.ff.shape[1], cfg)


def slab_extract_view(sl: Slabs, cfg: GCConfig) -> MapView:
    return ff_extract_view(slabs_to_ff(sl), sl.fdata.shape[0], cfg)


def ff_write_view(sf: SlabsFF, view, rows) -> SlabsFF:
    """One drop-mode column scatter of the resident view rows to their slab
    columns ``view.put_idx`` (duplicate and pad rows point out of range);
    in place."""
    put_drop_(sf.ff, 1, view.put_idx, rows.T)
    return sf


def ff_select_view_pages(sf: SlabsFF, S: int, cfg: GCConfig):
    """Paged view membership: per tile, the top pages by summed valid
    weight (weight half, first) and by max created_seq (recency half;
    duplicates of weight pages flagged). Returns (pages (S, Vp), dup)."""
    P = cfg.view_page
    cf, SM = sf.ff.shape
    M = SM // S
    npg = M // P
    Vp = cfg.m_tile_view // P
    o = _O_SCAL
    ff = sf.ff
    vmask = (ff[o + _ROW_V] > 0.5).reshape(S, npg, P)
    w = torch.where(vmask, ff[o + _ROW_W].reshape(S, npg, P), 0.0)
    cs = torch.where(vmask, ff[o + _ROW_CS].reshape(S, npg, P), -1.0)
    kwp = min(Vp - Vp // 2, npg)
    krp = min(Vp // 2, npg)
    _, pw = top_k(torch.sum(w, -1), kwp)
    if krp > 0:
        _, pr = top_k(torch.amax(cs, -1), krp)
        dup_r = torch.any(pr[:, :, None] == pw[:, None, :], 2)
        pages = torch.cat([pw, pr], 1)
        dup = torch.cat([torch.zeros((S, kwp), dtype=torch.bool,
                                     device=ff.device), dup_r], 1)
    else:
        pages, dup = pw, torch.zeros((S, kwp), dtype=torch.bool,
                                     device=ff.device)
    if pages.shape[1] < Vp:
        pad = Vp - pages.shape[1]
        pages = torch.nn.functional.pad(pages, (0, pad))
        dup = torch.nn.functional.pad(dup, (0, pad), value=True)
    return pages, dup


def ff_gather_pages(sf: SlabsFF, pages, dup, S: int, cfg: GCConfig):
    """Gather the selected pages. Returns (rows (V, CF), slab_cols (V,),
    dup_f (V,), prim_ids (V,), put_pages (S*Vp,) with S*npg = drop)."""
    P = cfg.view_page
    cf, SM = sf.ff.shape
    M = SM // S
    npg = M // P
    dev = sf.ff.device
    pflat = (torch.arange(S, device=dev)[:, None] * npg + pages).reshape(-1)
    rows = (sf.ff.reshape(cf, S * npg, P).index_select(1, pflat)
            .reshape(cf, -1).T.contiguous())
    prim_ids = sf.prim_ids.reshape(S * npg, P).index_select(0, pflat)
    base = torch.arange(S, device=dev)[:, None] * M + pages * P
    slab_cols = (base[..., None]
                 + torch.arange(P, device=dev)).reshape(-1)
    dup_f = dup.reshape(-1, 1).expand(-1, P).reshape(-1)
    put_pages = torch.where(dup.reshape(-1), S * npg, pflat)
    return rows, slab_cols, dup_f, prim_ids.reshape(-1), put_pages


def ff_write_view_pages(sf: SlabsFF, put_pages, rows, S: int,
                        cfg: GCConfig) -> SlabsFF:
    """One drop-mode page scatter of the resident view rows (in place)."""
    P = cfg.view_page
    cf, SM = sf.ff.shape
    ff3 = sf.ff.view(cf, SM // P, P)
    put_drop_(ff3, 1, put_pages, rows.T.reshape(cf, -1, P))
    return sf


def view_from_rows(g, slab_cols, dup_f, prim_ids, SM: int,
                   cfg: GCConfig) -> MapView:
    """Derive the MapView (positions, directions, packed, ...) from the
    gathered field rows ``g (V, CF)``."""
    o = _O_SCAL
    dt = g.dtype
    Lam = sym6_to_mat33(g[:, 0:6])
    eta0 = g[:, _O_ETA:_O_ETA + 3]
    wv = g[:, o + _ROW_W]
    val = (g[:, o + _ROW_V] > 0.5) & ~dup_f
    pos = torch.einsum("nij,nj->ni", inv3x3(Lam, cfg.eps_lift), g[:, 6:9])
    kap = torch.linalg.norm(eta0, dim=-1)
    ez = const([0.0, 0.0, 1.0], g).expand(eta0.shape)
    dirs = torch.where(kap[:, None] > cfg.eps_mass,
                       eta0 / torch.clamp(kap[:, None], min=cfg.eps_mass), ez)
    lam6 = g[:, 0:6]
    tr = lam6[:, 0] + lam6[:, 3] + lam6[:, 5]
    shape6 = lam6 / torch.clamp(tr, min=cfg.eps_lift)[:, None]
    f = cfg.p2p_shape_floor
    eye6 = const([1.0, 0.0, 0.0, 1.0, 0.0, 1.0], g)[None, :]
    has = (tr > cfg.eps_lift)[:, None].to(dt)
    shape6 = (1.0 - f) * shape6 + f * eye6 * has
    packed = torch.cat([
        pos, dirs, kap[:, None], shape6, wv[:, None], val.to(dt)[:, None],
        g[:, o + _ROW_LS][:, None], slab_cols.to(dt)[:, None],
        (tr / 3.0)[:, None], g[:, o + _ROW_CS][:, None]], 1)
    return MapView(
        positions=pos, Lambdas=Lam, directions=dirs, kappas=kap, weights=wv,
        valid=val, last_supported=g[:, o + _ROW_LS].to(torch.int32),
        prim_ids=prim_ids, slab_idx=slab_cols, packed=packed, raw=g,
        put_idx=torch.where(dup_f, SM, slab_cols))


def _fuse_base_rows(batch_w: MeasurementBatch, cf: int,
                    cam_geom_scale: float = 1.0):
    """Per-measurement (N, CF) additive contribution rows in field order."""
    dt = batch_w.weights.dtype
    N = batch_w.weights.shape[0]
    is_cam = (batch_w.sources == 0).to(dt)
    is_lid = (batch_w.sources == 1).to(dt)
    w = batch_w.weights
    col = torch.clamp(batch_w.colors, 0.0, 1.0)
    n_pad = cf - _O_ETA - batch_w.etas.shape[1] * 3
    lam6 = mat33_to_sym6(batch_w.Lambdas)
    th = batch_w.thetas
    cam_geom_scale = min(max(cam_geom_scale, 0.0), 1.0)
    if cam_geom_scale != 1.0:
        gs = (1.0 - (1.0 - cam_geom_scale) * is_cam)[:, None]
        lam6 = lam6 * gs
        th = th * gs
    z = w.new_zeros((N, 1))
    return torch.cat([
        lam6, th, (w * is_cam)[:, None] * col, w[:, None],
        (w * is_cam)[:, None], (w * is_lid)[:, None], (w * is_cam)[:, None],
        z, z, z, batch_w.etas.reshape(N, -1), w.new_zeros((N, n_pad))], 1)


def compact_fuse(view: MapView, batch_w: MeasurementBatch, resp,
                 cand_view_idx, cand_valid, scan_seq, cfg: GCConfig):
    """PoE fuse on the compact view rows: the N*K responsibility-weighted
    contributions accumulate into a (V, CF) delta by the moment segment-sum
    (kernel K4); supported rows stamp ``last_supported = scan_seq``."""
    raw = view.raw
    V, cf = raw.shape
    o = _O_SCAL
    dt = raw.dtype
    r = resp * batch_w.valid[:, None].to(dt) * cand_valid.to(dt)
    rf = r.reshape(-1)
    base = _fuse_base_rows(batch_w, cf, cfg.camera_fuse_geom_scale)
    N, K = r.shape
    vals = (base[:, None, :] * r[:, :, None]).reshape(N * K, cf)
    delta = surfel_kernels.moment_segment_sum(
        vals.T.contiguous(), cand_view_idx.reshape(-1), V, site="fuse").T
    rows = raw + delta
    rows[:, o + _ROW_LS] = torch.where(delta[:, o + _ROW_W] > 0.0,
                                       scan_seq.to(dt), raw[:, o + _ROW_LS])
    wk = batch_w.weights[:, None].expand(N, K).reshape(-1)
    certs = {
        "map.fused_mass": torch.sum(rf * wk),
        "map.fuse_resp_total": torch.sum(rf),
        "map.effect_predicted": torch.sum(resp * wk.reshape(N, K)),
        "map.effect_realized": torch.sum(rf * wk),
    }
    return rows, certs


def ff_fuse(sf: SlabsFF, batch_w: MeasurementBatch, resp, cand_view_idx,
            cand_valid, view_slab_idx, scan_seq, cfg: GCConfig):
    """PoE fuse straight into the slabs (the standalone form of
    ``compact_fuse``): the N*K contributions accumulate per view row, then
    the V row deltas add into their slab columns (view rows of one slot add
    up), both by the moment segment-sum (K4, no float atomics); a support
    marker rides a spare pad row and stamps ``last_supported``. Returns
    (sf', certs); ``sf`` is left as it was."""
    ff = sf.ff
    cf, SM = ff.shape
    o = _O_SCAL
    dt = ff.dtype
    N, K = resp.shape
    V = view_slab_idx.shape[0]
    r = resp * batch_w.valid[:, None].to(dt) * cand_valid.to(dt)
    rf = r.reshape(-1)
    has_pad = cf > _O_ETA + batch_w.etas.shape[1] * 3
    marker = cf - 1 if has_pad else o + _ROW_LS
    base = _fuse_base_rows(batch_w, cf, cfg.camera_fuse_geom_scale)
    base[:, marker] = 1.0
    vals = (base[:, None, :] * r[:, :, None]).reshape(N * K, cf)
    delta = surfel_kernels.moment_segment_sum(
        vals.T.contiguous(), cand_view_idx.reshape(-1), V, site="fuse")
    ls_prev = ff[o + _ROW_LS]
    ff = ff + surfel_kernels.moment_segment_sum(delta, view_slab_idx, SM,
                                                site="fuse")
    seqf = torch.as_tensor(scan_seq, dtype=dt, device=ff.device)
    if has_pad:
        ff[o + _ROW_LS] = torch.where(ff[marker] > 0.0, seqf, ls_prev)
        ff[marker] = 0.0
    else:
        ff[o + _ROW_LS] = torch.where(ff[o + _ROW_LS] > ls_prev, seqf,
                                      ls_prev)
    wk = batch_w.weights[:, None].expand(N, K).reshape(-1)
    certs = {"map.fused_mass": torch.sum(rf * wk),
             "map.fuse_resp_total": torch.sum(rf)}
    return sf._replace(ff=ff), certs


def compact_merge_reduce(rows, S: int, kw: int, cfg: GCConfig):
    """Merge-reduce on each tile's weight-half prefix of the view rows."""
    if cfg.k_merge_pairs <= 0:
        return rows, {"map.merged_pairs": rows.new_zeros(())}
    V, cf = rows.shape
    Vt = V // S
    Sm = min(cfg.merge_max_tile, max(kw, 1))
    rows3 = rows.reshape(S, Vt, cf).clone()
    outs, n_merged = _merge_tiles(rows3[:, :Sm], cfg)
    rows3[:, :Sm] = outs
    return (rows3.reshape(V, cf),
            {"map.merged_pairs": torch.sum(n_merged).to(rows.dtype)})


def _merge_tiles(g, cfg: GCConfig):
    """Greedy Bhattacharyya pair merge on (S, Sm, CF) tile row blocks:
    the 4P closest valid pairs of each tile, greedy disjoint picks below
    ``merge_threshold``, moment-matched merges. Returns (rows, counts (S,))."""
    S, Sm, cf = g.shape
    o = _O_SCAL
    dt = g.dtype
    dev = g.device
    eps_lift, eps_psd = cfg.eps_lift, cfg.eps_psd
    P = cfg.k_merge_pairs
    nB3 = 3 * cfg.vmf_n_lobes
    Lam = sym6_to_mat33(g[..., 0:6])
    eta = g[..., _O_ETA:_O_ETA + nB3]
    ra = g[..., 9:12]
    w = g[..., o + _ROW_W]
    v = g[..., o + _ROW_V] > 0.5
    cm, lm, rd = g[..., o + _ROW_CM], g[..., o + _ROW_LM], g[..., o + _ROW_RD]
    cs_k, ls_k = g[..., o + _ROW_CS], g[..., o + _ROW_LS]

    Sig = inv3x3(Lam, eps_lift)
    mu = torch.einsum("snij,snj->sni", Sig, g[..., 6:9])
    det = det3x3(Sig)
    Sbar = 0.5 * (Sig[:, :, None] + Sig[:, None, :])
    detS = det3x3(Sbar)
    dmu = mu[:, :, None, :] - mu[:, None, :, :]
    quad = 0.125 * torch.einsum("sabi,sabij,sabj->sab", dmu,
                                inv3x3(Sbar, eps_lift), dmu)
    logt = 0.5 * torch.log(torch.clamp(detS, min=1e-30) / torch.sqrt(
        torch.clamp(det[:, :, None] * det[:, None, :], min=0.0) + 1e-24))
    D = quad + logt
    tri = torch.ones((Sm, Sm), dtype=torch.bool, device=dev).triu(1)
    D = torch.where(v[:, :, None] & v[:, None, :] & tri, D, float("inf"))
    PC = min(4 * P, Sm * Sm)
    negd, flat = top_k(-D.reshape(S, -1), PC)
    d_work = -negd
    i_c = torch.div(flat, Sm, rounding_mode="floor")
    j_c = flat % Sm
    sel_i, sel_j, sel_ok = [], [], []
    for _ in range(P):
        b = torch.argmin(d_work, 1, keepdim=True)
        d_b = torch.gather(d_work, 1, b)
        ok = torch.isfinite(d_b) & (d_b < cfg.merge_threshold)
        ib, jb = torch.gather(i_c, 1, b), torch.gather(j_c, 1, b)
        sel_i.append(ib)
        sel_j.append(jb)
        sel_ok.append(ok)
        conflict = (i_c == ib) | (i_c == jb) | (j_c == ib) | (j_c == jb)
        d_work = torch.where(ok & conflict, float("inf"),
                             d_work.scatter(1, b, float("inf")))
    si = torch.cat(sel_i, 1)                                  # (S, P)
    sj = torch.cat(sel_j, 1)
    ok_p = torch.cat(sel_ok, 1)

    sr = torch.arange(S, device=dev)[:, None]
    Sig_i, Sig_j = Sig[sr, si], Sig[sr, sj]
    mu_i, mu_j = mu[sr, si], mu[sr, sj]
    w1, w2 = w[sr, si], w[sr, sj]
    ws = torch.clamp(w1 + w2, min=eps_psd)
    mu_m = (w1[..., None] * mu_i + w2[..., None] * mu_j) / ws[..., None]
    d1 = mu_i - mu_m
    d2 = mu_j - mu_m
    Sig_m = (w1[..., None, None] * (Sig_i + d1[..., :, None] * d1[..., None, :])
             + w2[..., None, None] * (Sig_j + d2[..., :, None]
                                      * d2[..., None, :])) / ws[..., None, None]
    Sig_m = Sig_m + eps_psd * torch.eye(3, dtype=dt, device=dev)
    Lam_m = inv3x3(Sig_m)
    the_m = torch.einsum("spij,spj->spi", Lam_m, mu_m)
    eta_m = (w1[..., None] * eta[sr, si] + w2[..., None] * eta[sr, sj]) \
        / ws[..., None]
    n_pad = cf - _O_ETA - nB3
    z = g.new_zeros((S, P, 1))
    row_i = torch.cat([
        mat33_to_sym6(Lam_m), the_m, ra[sr, si] + ra[sr, sj], ws[..., None],
        (cm[sr, si] + cm[sr, sj])[..., None],
        (lm[sr, si] + lm[sr, sj])[..., None],
        (rd[sr, si] + rd[sr, sj])[..., None],
        cs_k[sr, si][..., None], ls_k[sr, si][..., None],
        v[sr, si].to(dt)[..., None], eta_m, g.new_zeros((S, P, n_pad))], 2)
    gj = g[sr, sj]
    row_j = torch.cat([
        gj[..., 0:9], g.new_zeros((S, P, 3)), z, z, z, z,
        cs_k[sr, sj][..., None], ls_k[sr, sj][..., None], z,
        gj[..., _O_ETA:_O_ETA + nB3], g.new_zeros((S, P, n_pad))], 2)
    out = g.reshape(S * Sm, cf).clone()
    base = sr * Sm
    put_drop_(out, 0, torch.where(ok_p, base + si, S * Sm).reshape(-1),
              row_i.reshape(S * P, cf))
    put_drop_(out, 0, torch.where(ok_p, base + sj, S * Sm).reshape(-1),
              row_j.reshape(S * P, cf))
    return out.reshape(S, Sm, cf), torch.sum(ok_p.to(torch.int32), 1)


def ff_page_stats(sf: SlabsFF, S: int, cfg: GCConfig, scan_seq):
    """Per-page insert-targeting aggregates: (invalid-slot counts, retention
    sums), both (S, npg)."""
    ff = sf.ff
    o = _O_SCAL
    dt = ff.dtype
    M = ff.shape[1] // S
    P = cfg.view_page
    npg = M // P
    vmask = ff[o + _ROW_V].reshape(S, M) > 0.5
    stale = torch.clamp(scan_seq.to(dt) - ff[o + _ROW_LS].reshape(S, M),
                        min=0.0)
    ret = torch.where(vmask, ff[o + _ROW_W].reshape(S, M)
                      * torch.exp(-cfg.recency_decay_lambda * stale), 0.0)
    inv_cnt = torch.sum((~vmask).reshape(S, npg, P), -1).to(dt)
    return inv_cnt, torch.sum(ret.reshape(S, npg, P), -1)


def ff_insert(sf: SlabsFF, batch_w: MeasurementBatch, novelty, meas_keys,
              active_keys, scan_seq, cfg: GCConfig, evict_exclude=None,
              resident_pages=None, page_stats=None):
    """Insert the top-``k_insert`` novel measurements of each active tile
    (insert weight = novelty x measurement weight; proposals below the cull
    threshold are skipped). Writes ``sf`` in place.

    Per slot (``resident_pages`` None): each tile evicts its K
    lowest-retention slots (invalid first, then weight x exp(-lambda x
    staleness)); a proposal whose slot is in ``evict_exclude`` (the
    resident view's columns) is dropped. Returns (sf, certs).

    Paged (``resident_pages``, the flat resident pages): the K
    lowest-retention slots of one non-resident page per tile (the fullest
    page that still fits K, else the least retention), from ``page_stats``
    (computed here when None). With ``insert_page_dense`` the target pages
    are gathered and written back whole (K6, the batched replay's form);
    otherwise the inserts are a column scatter. Returns (sf, certs,
    page_stats') when ``page_stats`` is given, else (sf, certs)."""
    ff = sf.ff
    cf, SM = ff.shape
    S = active_keys.shape[0]
    M = SM // S
    o = _O_SCAL
    dt = ff.dtype
    dev = ff.device
    K = cfg.k_insert
    seqf = torch.as_tensor(scan_seq, dtype=dt, device=dev)

    score = torch.where(batch_w.valid, novelty * batch_w.weights, -1e30)
    in_tile = meas_keys[None, :] == active_keys[:, None]
    score_t = torch.where(in_tile, score[None, :], -1e30)
    top_score, ins_idx = top_k(score_t, K)
    do_insert = torch.gather(in_tile, 1, ins_idx) & (top_score > -1e20)

    paged = resident_pages is not None
    if paged:
        P = cfg.view_page
        npg = M // P
        assert npg * P > cfg.m_tile_view, (M, cfg.m_tile_view)
        assert K <= P, (K, P)
        returns_stats = page_stats is not None
        inv_cnt, ret_pg = (page_stats if returns_stats
                           else ff_page_stats(sf, S, cfg, scan_seq))
        pscore = torch.where(inv_cnt >= K, inv_cnt, 1e8 + ret_pg)
        pages_glob = (torch.arange(S, device=dev)[:, None] * npg
                      + torch.arange(npg, device=dev)[None, :])
        excl = torch.any(pages_glob[:, :, None]
                         == resident_pages[None, None, :], -1)
        pscore = torch.where(excl, float("inf"), pscore)
        tgt_page = torch.argmin(pscore, 1)
        offs = torch.arange(S, device=dev) * M + tgt_page * P
        cols = (offs[:, None]
                + torch.arange(P, device=dev)[None, :]).reshape(-1)
        if cfg.insert_page_dense:
            page = atlas_kernels.page_gather_ff(ff, offs, P)   # K6
        else:
            page = ff[:, cols]
        w_in = page[o + _ROW_W].reshape(S, P)
        ls_in = page[o + _ROW_LS].reshape(S, P)
        v_in = page[o + _ROW_V].reshape(S, P) > 0.5
        ret_in = torch.where(v_in, w_in * torch.exp(
            -cfg.recency_decay_lambda * torch.clamp(seqf - ls_in, min=0.0)),
            -1.0)
        _, slot_in = top_k(-ret_in, K)
        evict_slot = tgt_page[:, None] * P + slot_in
    else:
        vmask = ff[o + _ROW_V].reshape(S, M) > 0.5
        stale = torch.clamp(seqf - ff[o + _ROW_LS].reshape(S, M), min=0.0)
        retention = torch.where(vmask, ff[o + _ROW_W].reshape(S, M)
                                * torch.exp(-cfg.recency_decay_lambda
                                            * stale), -1.0)
        _, evict_slot = top_k_maybe_approx(-retention, K, cfg.approx_topk)

    tgt = (torch.arange(S, device=dev)[:, None] * M
           + evict_slot).reshape(-1)
    do_f = do_insert.reshape(-1)
    if evict_exclude is not None:
        # A resident view column is never evicted: the chunk's write-back
        # would clobber the insert. The proposal is dropped, not re-slotted.
        do_f = do_f & ~torch.any(tgt[:, None] == evict_exclude[None, :], 1)
    gi = ins_idx.reshape(-1)
    w_new = novelty[gi] * batch_w.weights[gi]
    do_f = do_f & (w_new >= cfg.cull_weight_threshold)
    prefix = torch.cumsum(do_f.to(torch.int32), 0) - 1
    new_ids = torch.where(do_f, sf.next_prim_id + prefix, -1).to(torch.int32)
    w_new = torch.where(do_f, w_new, 0.0)
    sub = _fuse_base_rows(MeasurementBatch(
        Lambdas=batch_w.Lambdas[gi], thetas=batch_w.thetas[gi],
        etas=batch_w.etas[gi], weights=w_new, valid=batch_w.valid[gi],
        sources=batch_w.sources[gi], colors=batch_w.colors[gi]), cf)
    sub[:, o + _ROW_CS] = seqf
    sub[:, o + _ROW_LS] = seqf
    sub[:, o + _ROW_V] = 1.0
    if paged and cfg.insert_page_dense:
        # Every eviction slot lives in the one gathered target page of its
        # tile: merge the S*K proposals into the (CF, S, P) page and write
        # the same contiguous page columns back (K6), instead of a scattered
        # column insert.
        onek = ((slot_in[:, :, None] == torch.arange(P, device=dev))
                & do_f.reshape(S, K)[:, :, None])                # (S, K, P)
        hit = torch.any(onek, 1)                                 # (S, P)
        merged = torch.einsum("skp,skc->csp", onek.to(dt),
                              sub.reshape(S, K, cf))
        upd = torch.where(hit[None], merged, page.reshape(cf, S, P))
        atlas_kernels.page_writeback_ff(ff, offs, upd.reshape(cf, S * P), P)
        id_sel = torch.sum(onek * new_ids.reshape(S, K, 1), 1)
        pp = sf.prim_ids[cols].reshape(S, P)
        sf.prim_ids.index_put_((cols,), torch.where(hit, id_sel, pp)
                               .reshape(-1).to(torch.int32))
    else:
        tgt_put = torch.where(do_f, tgt, SM)
        put_drop_(ff, 1, tgt_put, sub.T)
        put_drop_(sf.prim_ids, 0, tgt_put, new_ids)
    # torch.sum of int32 is int64; the id counter stays int32, as it is in
    # the reference's state.
    n_ins = torch.sum(do_f.to(torch.int32), dtype=torch.int32)
    sf = sf._replace(next_prim_id=sf.next_prim_id + n_ins)
    ins_mass = torch.sum(w_new * do_f.to(dt))
    certs = {
        "map.inserted_count": torch.sum(do_f.to(dt)),
        "map.inserted_mass": ins_mass,
        "map.insert.effect_predicted": torch.sum(torch.where(
            batch_w.valid, novelty * batch_w.weights, 0.0)),
        "map.insert.effect_realized": ins_mass,
    }
    if not (paged and returns_stats):
        return sf, certs
    do_sk = do_f.reshape(S, K)
    was_invalid = torch.gather(~v_in, 1, slot_in)
    filled = torch.sum((do_sk & was_invalid).to(dt), 1)
    ret_ev = torch.clamp(torch.gather(ret_in, 1, slot_in), min=0.0)
    dmass = torch.sum(torch.where(do_sk, w_new.reshape(S, K) - ret_ev, 0.0),
                      1)
    hit = tgt_page[:, None] == torch.arange(npg, device=dev)[None, :]
    inv_cnt = torch.where(hit, inv_cnt + (-filled)[:, None], inv_cnt)
    ret_pg = torch.where(hit, ret_pg + dmass[:, None], ret_pg)
    return sf, certs, (inv_cnt, ret_pg)


def ff_cull(sf: SlabsFF, cfg: GCConfig):
    """Invalidate primitives below the weight threshold (standalone; the
    pipeline folds the cull into the dense pass). Returns (sf', certs)."""
    o = _O_SCAL
    dt = sf.ff.dtype
    w, v = sf.ff[o + _ROW_W], sf.ff[o + _ROW_V]
    below = (v > 0.5) & (w < cfg.cull_weight_threshold)
    certs = {"map.culled_count": torch.sum(below.to(dt)),
             "map.culled_mass": torch.sum(w * below.to(dt))}
    ff = sf.ff.clone()
    ff[o + _ROW_V] = torch.where(below, 0.0, v)
    ff[o + _ROW_W] = torch.where(below, 0.0, w)
    return sf._replace(ff=ff), certs


def ff_forget(sf: SlabsFF, cfg: GCConfig) -> SlabsFF:
    """weights x ``forgetting_factor`` (standalone)."""
    ff = sf.ff.clone()
    ff[_O_SCAL + _ROW_W] *= cfg.forgetting_factor
    return sf._replace(ff=ff)


def ff_merge_reduce(sf: SlabsFF, S: int, cfg: GCConfig):
    """Greedy Bhattacharyya merge of up to ``k_merge_pairs`` pairs per tile
    on each tile's top-``merge_max_tile`` valid slots by weight, gathered
    with one column gather and written back with one column scatter
    (standalone; the pipeline merges the view rows). Returns (sf', certs)."""
    if cfg.k_merge_pairs <= 0:
        return sf, {"map.merged_pairs": sf.ff.new_zeros(())}
    ff = sf.ff
    cf, SM = ff.shape
    M = SM // S
    o = _O_SCAL
    Sm = min(cfg.merge_max_tile, M)
    sc = torch.where(ff[o + _ROW_V].reshape(S, M) > 0.5,
                     ff[o + _ROW_W].reshape(S, M), float("-inf"))
    _, subs = top_k_maybe_approx(sc, Sm, cfg.approx_topk)
    gidx = (torch.arange(S, device=ff.device)[:, None] * M
            + subs).reshape(-1)
    outs, n_merged = _merge_tiles(ff[:, gidx].T.reshape(S, Sm, cf), cfg)
    ff = ff.clone()
    ff[:, gidx] = outs.reshape(S * Sm, cf).T
    return sf._replace(ff=ff), {
        "map.merged_pairs": torch.sum(n_merged).to(ff.dtype)}


def total_count(atlas: AtlasMap):
    return torch.sum(field_valid(atlas.fdata))


# ---------------------------------------------------------------------------
# Row-major slab wrappers around the ff ops and the atlas-level wrappers
# (tests and one-off use; each converts with a copy).
# ---------------------------------------------------------------------------

def slab_fuse(sl: Slabs, batch_w, resp, cand_view_idx, cand_valid,
              view_slab_idx, scan_seq, cfg: GCConfig):
    sf, certs = ff_fuse(slabs_to_ff(sl), batch_w, resp, cand_view_idx,
                        cand_valid, view_slab_idx, scan_seq, cfg)
    return slabs_from_ff(sf, sl.fdata.shape[0]), certs


def slab_insert(sl: Slabs, batch_w, novelty, meas_keys, active_keys,
                scan_seq, cfg: GCConfig):
    sf, certs = ff_insert(slabs_to_ff(sl), batch_w, novelty, meas_keys,
                          active_keys, scan_seq, cfg)
    return slabs_from_ff(sf, sl.fdata.shape[0]), certs


def slab_cull(sl: Slabs, cfg: GCConfig):
    sf, certs = ff_cull(slabs_to_ff(sl), cfg)
    return slabs_from_ff(sf, sl.fdata.shape[0]), certs


def slab_forget(sl: Slabs, cfg: GCConfig) -> Slabs:
    return slabs_from_ff(ff_forget(slabs_to_ff(sl), cfg), sl.fdata.shape[0])


def slab_merge_reduce(sl: Slabs, cfg: GCConfig):
    sf, certs = ff_merge_reduce(slabs_to_ff(sl), sl.fdata.shape[0], cfg)
    return slabs_from_ff(sf, sl.fdata.shape[0]), certs


def recency_inflate(atlas: AtlasMap, slots, scan_seq, cfg: GCConfig):
    sl, certs = slab_recency_inflate(gather_slabs(atlas, slots), scan_seq,
                                     cfg)
    return scatter_slabs(atlas, slots, sl), certs


def extract_view(atlas: AtlasMap, slots, cfg: GCConfig) -> MapView:
    return slab_extract_view(gather_slabs(atlas, slots), cfg)


def fuse(atlas: AtlasMap, batch_w, resp, cand_view_idx, cand_valid,
         view_slab_idx, scan_seq, cfg: GCConfig, slots=None):
    assert slots is not None, "fuse needs the active slots"
    sl, certs = slab_fuse(gather_slabs(atlas, slots), batch_w, resp,
                          cand_view_idx, cand_valid, view_slab_idx, scan_seq,
                          cfg)
    return scatter_slabs(atlas, slots, sl), certs


def insert(atlas: AtlasMap, batch_w, novelty, meas_keys, active_keys, slots,
           scan_seq, cfg: GCConfig):
    sl, certs = slab_insert(gather_slabs(atlas, slots), batch_w, novelty,
                            meas_keys, active_keys, scan_seq, cfg)
    return scatter_slabs(atlas, slots, sl), certs


def cull(atlas: AtlasMap, slots, cfg: GCConfig):
    sl, certs = slab_cull(gather_slabs(atlas, slots), cfg)
    return scatter_slabs(atlas, slots, sl), certs


def forget(atlas: AtlasMap, slots, cfg: GCConfig) -> AtlasMap:
    return scatter_slabs(atlas, slots,
                         slab_forget(gather_slabs(atlas, slots), cfg))


def merge_reduce(atlas: AtlasMap, slots, cfg: GCConfig):
    sl, certs = slab_merge_reduce(gather_slabs(atlas, slots), cfg)
    return scatter_slabs(atlas, slots, sl), certs


def decode_positions(atlas: AtlasMap, eps_lift: float = 1e-9):
    """World positions (P, M, 3) of every slot (invalid slots undefined)."""
    return torch.einsum("pmij,pmj->pmi",
                        inv3x3(dense_Lambdas(atlas.fdata), eps_lift),
                        dense_thetas(atlas.fdata))


# ---------------------------------------------------------------------------
# Field views and dense accessors of a fused block ``fdata (A, CF, M)`` (the
# pool's, A = P): scalar rows come back (A, M), block fields dense
# (A, M, ...). Export and render read them; the per-scan path does not.
# ---------------------------------------------------------------------------

_GRAY = (0.5, 0.5, 0.5)


def field_weights(fd):
    return fd[:, _O_SCAL + _ROW_W]


def field_cam_mass(fd):
    return fd[:, _O_SCAL + _ROW_CM]


def field_lidar_mass(fd):
    return fd[:, _O_SCAL + _ROW_LM]


def field_created_seq(fd):
    return fd[:, _O_SCAL + _ROW_CS].to(torch.int32)


def field_last_supported(fd):
    return fd[:, _O_SCAL + _ROW_LS].to(torch.int32)


def field_valid(fd):
    return fd[:, _O_SCAL + _ROW_V] > 0.5


def dense_Lambdas(fd):
    """(A, M, 3, 3) dense symmetric precisions."""
    return sym6_to_mat33(fd[:, 0:6].movedim(1, -1))


def dense_thetas(fd):
    return fd[:, 6:9].movedim(1, -1)                          # (A, M, 3)


def dense_etas(fd, n_lobes: int):
    e = fd[:, _O_ETA:_O_ETA + 3 * n_lobes].movedim(1, -1)    # (A, M, B*3)
    return e.reshape(e.shape[:-1] + (n_lobes, 3))            # (A, M, B, 3)


def dense_rgb(fd, eps_mass: float = 1e-12):
    """Resolved camera-dominant color, derived from the accumulators."""
    acc = fd[:, 9:12].movedim(1, -1)                          # (A, M, 3)
    den = fd[:, _O_SCAL + _ROW_RD][..., None]
    return torch.where(field_cam_mass(fd)[..., None] > 0,
                       torch.clamp(acc / torch.clamp(den, min=eps_mass),
                                   0.0, 1.0), const(_GRAY, acc))
