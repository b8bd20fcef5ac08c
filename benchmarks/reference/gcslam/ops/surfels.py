"""LiDAR surfel extraction via MA-Hex-3D binning (port of
``fl_slam_tpu/ops/surfels.py``): per-cell weighted moments of cell-local
coordinates in ONE moment segment-sum (kernel K4,
``surfel_kernels.moment_segment_sum``), then a closed-form per-cell plane
fit and a deterministic budget selection (valid cells first, ascending id)."""

from __future__ import annotations

import math

import torch

from ..config import GCConfig
from ..core.hexgrid import (bin_cell_ids_local,
                                            cell_centers_from_ids)
from ..core.linalg import (sym6_to_mat33, sym6p_eigvals,
                                           sym6p_eigvec, sym6p_inv)
from ..ops import surfel_kernels
from ..runtime import const

MIN_POINTS_PER_CELL = 3
SENSOR_VAR = 1e-4
WISHART_NU = 5.0
WISHART_PSI = 0.1
KAPPA_SCALE = 10.0
KAPPA_MIN = 0.1
KAPPA_MAX = 100.0
EIG_MIN = 1e-12


def percentile_f32(x, pct: float):
    """Linear-interpolated percentile of a 1-D tensor taken in f32, with
    the reference's (``jnp.percentile`` under x64) rank and weights in f64.
    XLA may round the f64 result to f32 the other way at an exact tie."""
    n = x.shape[0]
    qn = pct / 100.0 * (n - 1)
    low, high = math.floor(qn), math.ceil(qn)
    hw = qn - low
    s = torch.sort(x.to(torch.float32)).values.to(torch.float64)
    return (s[low] * (1.0 - hw) + s[high] * hw).to(torch.float32)


def extract_surfels(points_p, weights, cfg: GCConfig):
    """points_p (3, N) planes, weights (N,) -> (surfel dict, certs);
    S = cfg.n_surfel rows."""
    dt = cfg.torch_dtype
    dev = points_p.device
    points_p = points_p.to(dt)
    weights = weights.to(dt)
    c1, c2, cz = cfg.surfel_cells_1, cfg.surfel_cells_2, cfg.surfel_cells_z
    n_cells = c1 * c2 * cz

    finite = torch.all(torch.abs(points_p) < 0.1 * cfg.nonfinite_sentinel, 0)
    w_fin = weights * finite.to(dt)
    w_tot_fin = torch.sum(w_fin) + EIG_MIN
    center = torch.sum(points_p * w_fin[None, :], 1) / w_tot_fin
    px = points_p[0] - center[0]
    py = points_p[1] - center[1]
    pz = points_p[2] - center[2]

    voxel_size = torch.full((), cfg.surfel_cell_size, dtype=dt, device=dev)
    if cfg.surfel_adaptive_cells:
        carry = finite & (weights > 1e-9)
        r_xy = torch.where(carry, torch.maximum(torch.abs(px), torch.abs(py)),
                           0.0)
        r95 = percentile_f32(r_xy, 95.0).to(dt)
        cover = 0.45 * min(c1, c2)
        voxel_size = torch.clamp(r95 / cover, cfg.surfel_cell_size,
                                 1.2 * cfg.range_weight_max_r / cover)
    else:
        r95 = torch.zeros((), dtype=dt, device=dev)

    cell, in_grid = bin_cell_ids_local(px, py, pz, voxel_size, c1, c2, cz)
    usable = finite & in_grid
    w_eff = weights * usable.to(dt)
    w_tot = torch.sum(w_eff) + EIG_MIN
    ccx, ccy, ccz = cell_centers_from_ids(cell, voxel_size, c1, c2, cz,
                                          dtype=dt)
    lx, ly, lz = px - ccx, py - ccy, pz - ccz
    payload = torch.stack([
        usable.to(dt), w_eff, w_eff * lx, w_eff * ly, w_eff * lz,
        w_eff * lx * lx, w_eff * lx * ly, w_eff * lx * lz,
        w_eff * ly * ly, w_eff * ly * lz, w_eff * lz * lz], 0)  # (11, N)
    mom = surfel_kernels.moment_segment_sum(payload, cell, n_cells,
                                            site="surfels")    # (11, C)
    cnt, sw = mom[0], mom[1]
    swp, swpp = mom[2:5], mom[5:11]

    swn = torch.clamp(sw, min=EIG_MIN)
    cc_all = torch.stack(cell_centers_from_ids(
        torch.arange(n_cells, dtype=torch.int32, device=dev), voxel_size,
        c1, c2, cz, dtype=dt))
    cenl = swp / swn[None]
    cen = cenl + cc_all
    cov = swpp / swn[None] - torch.stack([
        cenl[0] * cenl[0], cenl[0] * cenl[1], cenl[0] * cenl[2],
        cenl[1] * cenl[1], cenl[1] * cenl[2], cenl[2] * cenl[2]], 0)
    eye6 = const([1.0, 0.0, 0.0, 1.0, 0.0, 1.0], cov)[:, None]
    cov = cov + EIG_MIN * eye6

    lam = sym6p_eigvals(cov)
    normal = sym6p_eigvec(cov, lam[0])
    cen_body = cen + center[:, None]
    facing = torch.sum(normal * cen_body, 0)
    normal = normal * torch.where(facing > 0.0, -1.0, 1.0).to(dt)[None]

    Lam6 = sym6p_inv(cov + SENSOR_VAR * eye6, EIG_MIN)
    Lam6_reg = Lam6 + (WISHART_NU / WISHART_PSI) * eye6
    sigma_perp_sq = torch.clamp(lam[0], min=EIG_MIN)
    kappa = torch.clamp(cfg.kappa_scale * KAPPA_SCALE
                        / torch.sqrt(sigma_perp_sq), KAPPA_MIN, KAPPA_MAX)
    valid_cell = (cnt >= MIN_POINTS_PER_CELL) & (sw > 0.0)
    planarity = torch.clamp((lam[1] - lam[0]) / (lam[2] + EIG_MIN), 0.0, 1.0)
    sw = sw * planarity

    S = cfg.n_surfel
    cell_ids = torch.arange(n_cells, dtype=torch.int32, device=dev)
    key = cell_ids + (1 - valid_cell.to(torch.int32)) * n_cells
    order = torch.argsort(key)[:S]
    pad = S - min(S, n_cells)
    if pad > 0:
        order = torch.nn.functional.pad(order, (0, pad))

    allp = torch.cat([cen, Lam6_reg, normal, kappa[None], sw[None],
                      valid_cell.to(dt)[None]], 0)             # (15, C)
    g = allp[:, order]                                         # (15, S)
    pos_sel = (g[0:3] + center[:, None]).T
    Lam_sel = sym6_to_mat33(g[3:9].T)
    theta_sel = torch.einsum("sij,sj->si", Lam_sel, pos_sel)
    nrm_sel = g[9:12].T
    kap_sel = g[12]
    val_sel = g[14] > 0.5
    if pad > 0:
        val_sel = val_sel & (torch.arange(S, device=dev) < (S - pad))
    etas = torch.nn.functional.pad((kap_sel[:, None] * nrm_sel)[:, None],
                                   (0, 0, 0, cfg.vmf_n_lobes - 1))
    w_sel = torch.where(val_sel, g[13], 0.0)

    certs = {
        "surfel.n_valid": torch.sum(val_sel.to(dt)),
        "surfel.mass_total": torch.sum(w_sel),
        "surfel.point_mass_in": w_tot,
        "surfel.mass_out_of_grid": w_tot_fin - w_tot,
        "surfel.cell_size_eff": voxel_size,
        "surfel.r95_xy": r95,
        "surfel.budget_overflow": torch.clamp(
            torch.sum(valid_cell.to(dt)) - float(S), min=0.0),
        "surfel.effect_predicted": w_tot,
        "surfel.effect_realized": torch.sum(w_sel),
    }
    return {"Lambdas": Lam_sel, "thetas": theta_sel, "etas": etas,
            "weights": w_sel, "valid": val_sel, "positions": pos_sel,
            "normals": nrm_sel, "kappas": kap_sel}, certs
