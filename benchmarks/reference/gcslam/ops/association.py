"""Soft association via unbalanced Sinkhorn OT (port of
``fl_slam_tpu/ops/association.py``): dense cost over the map view,
top-K candidates per measurement (binned two-stage top-k under
``approx_topk``; the bf16 proxy score under ``select_bf16``, or the same
proxy fused with the top-K in kernel K9 under ``select_kernel``, re-scored
exactly), then the log-domain unbalanced Sinkhorn fixed point (kernel K3,
``assoc_kernels.sinkhorn_piT``) and the hard row-mass cap."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import GCConfig
from ..core.linalg import top_k_maybe_approx
from ..ops import assoc_kernels
from ..structures.atlas import MapView

COST_BETA = 0.5
COST_INVALID = 1e12


class AssociationResult(NamedTuple):
    responsibilities: torch.Tensor  # (N, K) transported mass pi
    cand_view_idx: torch.Tensor     # (N, K) int64 rows of the map view
    cand_slab_idx: torch.Tensor     # (N, K) int32 slab-flat indices
    cand_valid: torch.Tensor        # (N, K) bool
    row_masses: torch.Tensor        # (N,)
    cost: torch.Tensor              # (N, K)
    cand_packed: torch.Tensor       # (N, K, 19) gathered view.packed rows
    row_budget: torch.Tensor        # (N,) source marginal a


_DENSE_BLOCK = 1 << 21    # (measurement, view row) pairs a block holds


def _log_sinh_ratio(k, eps):
    """A_vmf(k) = log(4 pi) + log(sinh k) - log k, stable everywhere."""
    k = torch.clamp(k, min=eps)
    log_sinh = torch.where(
        k > 20.0, k - math.log(2.0),
        torch.where(k >= 1e-2, torch.log(torch.sinh(torch.clamp(k, max=20.0))),
                    torch.log(k + (k ** 3) / 6.0)))
    return math.log(4.0 * math.pi) + log_sinh - torch.log(k)


def associate(meas_pos, meas_dir, meas_kappa, meas_valid, view: MapView,
              scan_seq, cfg: GCConfig, meas_weights):
    """meas_* (N, ...) WORLD frame; returns (AssociationResult, certs)."""
    dt = meas_pos.dtype
    eps = cfg.ot_epsilon
    K = cfg.k_assoc
    eig_min = 1e-12
    eta_m = meas_kappa[:, None] * meas_dir
    A_k1 = _log_sinh_ratio(torch.clamp(meas_kappa, min=eig_min),
                           eig_min)[:, None]
    if assoc_kernels.use_select_kernel(cfg.select_kernel, meas_pos.shape[0],
                                       view.packed.shape[0], K):
        # Fused selection (K9): the proxy cost of the select_bf16 branch in
        # the working dtype, top-K in the kernel; the dense (N, V) matrices
        # below never materialize.
        k_eff = min(K, view.packed.shape[0])
        neg_cost, cand_view_idx = assoc_kernels.select_candidates(
            meas_pos, meas_dir, meas_kappa, view.packed, scan_seq, k=k_eff,
            cost_beta=COST_BETA,
            recency_scale=eps * cfg.recency_decay_lambda)
        return _finish_associate(meas_pos, meas_kappa, meas_valid,
                                 meas_weights, view, scan_seq, cfg, neg_cost,
                                 cand_view_idx, eta_m, A_k1, proxy_sel=True)
    x2 = torch.sum(meas_pos * meas_pos, -1)[:, None]
    m2 = torch.sum(view.positions * view.positions, -1)[None, :]
    cand_dt = torch.clamp(scan_seq - view.last_supported, min=0).to(dt)
    recency = (eps * cfg.recency_decay_lambda) * cand_dt[None, :]
    if cfg.select_bf16:
        # Selection-pass proxy: cosine direction term; ONE (N, 8) @ (8, V)
        # matmul carries the position cross term, the proxy and its gate.
        a_m = (meas_kappa > 0.0).to(dt)[:, None]
        b_v = (view.kappas > 0.0).to(dt)[:, None]
        half_beta = 0.5 * COST_BETA
        cat_m = torch.cat([2.0 * meas_pos, half_beta * a_m * meas_dir,
                           (-half_beta) * a_m, torch.zeros_like(a_m)], 1)
        cat_v = torch.cat([view.positions, b_v * view.directions, b_v,
                           torch.zeros_like(b_v)], 1)
        negC = cat_m @ cat_v.T - (x2 + m2 + recency)
        negC = torch.where(view.valid[None, :], negC, -COST_INVALID)
        k_eff = min(K, negC.shape[1])
        neg_cost, cand_view_idx = top_k_maybe_approx(
            negC.to(torch.bfloat16), k_eff, cfg.approx_topk)
        return _finish_associate(meas_pos, meas_kappa, meas_valid,
                                 meas_weights, view, scan_seq, cfg, neg_cost,
                                 cand_view_idx, eta_m, A_k1, proxy_sel=True)
    # The exact cost over every (measurement, view row) pair, by row blocks
    # of at most _DENSE_BLOCK pairs: rows are independent, and a block
    # bounds the (N, V) temporaries and the sort's buffers (GCConfig(): N =
    # 1,536, V = 7,168, six blocks; the test budgets take one).
    rows = max(1, _DENSE_BLOCK // max(1, view.packed.shape[0]))
    k_eff = min(K, view.packed.shape[0])
    parts = [_dense_select(p, kap, em, a1, x, view, recency, k_eff, cfg)
             for p, kap, em, a1, x in zip(
                 meas_pos.split(rows), meas_kappa.split(rows),
                 eta_m.split(rows), A_k1.split(rows), x2.split(rows))]
    neg_cost = torch.cat([p[0] for p in parts])
    cand_view_idx = torch.cat([p[1] for p in parts])
    return _finish_associate(meas_pos, meas_kappa, meas_valid, meas_weights,
                             view, scan_seq, cfg, neg_cost, cand_view_idx,
                             eta_m, A_k1, proxy_sel=False)


def _dense_select(meas_pos, meas_kappa, eta_m, A_k1, x2, view: MapView,
                  recency, k_eff: int, cfg: GCConfig):
    """The exact cost of a block of rows against every view row and its
    top ``k_eff`` (negated costs, view rows). The (rows, V) chain reuses
    its names, so each step frees the one before."""
    eig_min = 1e-12
    m2 = torch.sum(view.positions * view.positions, -1)[None, :]
    d_pos = x2 + m2 - 2.0 * meas_pos @ view.positions.T
    eta_v = view.kappas[:, None] * view.directions
    km = (meas_kappa[:, None] ** 2 + view.kappas[None, :] ** 2
          + 2.0 * (eta_m @ eta_v.T))
    km = 0.5 * torch.sqrt(torch.clamp(km, min=0.0))
    A_k2 = _log_sinh_ratio(torch.clamp(view.kappas, min=eig_min),
                           eig_min)[None, :]
    bc = torch.exp(_log_sinh_ratio(torch.clamp(km, min=eig_min), eig_min)
                   - 0.5 * (A_k1 + A_k2))
    del km
    dir_ok = (meas_kappa[:, None] > 0.0) & (view.kappas[None, :] > 0.0)
    C = d_pos + COST_BETA * torch.where(dir_ok, torch.clamp(1.0 - bc,
                                                            min=0.0), 0.0)
    del d_pos, bc, dir_ok
    C = torch.where(view.valid[None, :], C + recency, COST_INVALID)
    return top_k_maybe_approx(-C, k_eff, cfg.approx_topk)


def _finish_associate(meas_pos, meas_kappa, meas_valid, meas_weights, view,
                      scan_seq, cfg: GCConfig, neg_cost, cand_view_idx,
                      eta_m, A_k1, *, proxy_sel: bool):
    """Candidate gather + exact re-score + unbalanced Sinkhorn + row cap."""
    dt = meas_pos.dtype
    eps = cfg.ot_epsilon
    K = cfg.k_assoc
    eig_min = 1e-12
    N = meas_pos.shape[0]
    k_eff = neg_cost.shape[1]
    if k_eff < K:
        neg_cost = torch.nn.functional.pad(neg_cost, (0, K - k_eff),
                                           value=-COST_INVALID)
        cand_view_idx = torch.nn.functional.pad(cand_view_idx,
                                                (0, K - k_eff))
    cand_view_idx = cand_view_idx.to(torch.int64)
    cand_packed = view.packed[cand_view_idx.reshape(-1)].reshape(N, K, -1)
    if proxy_sel:
        cp, cd, ck = (cand_packed[..., 0:3], cand_packed[..., 3:6],
                      cand_packed[..., 6])
        d_pos_k = torch.sum((meas_pos[:, None, :] - cp) ** 2, -1)
        km2_k = (meas_kappa[:, None] ** 2 + ck ** 2
                 + 2.0 * ck * torch.einsum("ni,nki->nk", eta_m, cd))
        km_k = 0.5 * torch.sqrt(torch.clamp(km2_k, min=0.0))
        bc_k = torch.exp(_log_sinh_ratio(torch.clamp(km_k, min=eig_min),
                                         eig_min)
                         - 0.5 * (A_k1 + _log_sinh_ratio(
                             torch.clamp(ck, min=eig_min), eig_min)))
        d_dir_k = torch.where((meas_kappa[:, None] > 0.0) & (ck > 0.0),
                              torch.clamp(1.0 - bc_k, min=0.0), 0.0)
        dt_k = torch.clamp(scan_seq - cand_packed[..., 15].to(torch.int32),
                           min=0).to(dt)
        sel_bad = (-neg_cost.to(dt)) >= 0.5 * COST_INVALID
        C = torch.where((cand_packed[..., 14] > 0.5) & ~sel_bad,
                        d_pos_k + COST_BETA * d_dir_k
                        + (eps * cfg.recency_decay_lambda) * dt_k,
                        COST_INVALID)
    else:
        C = -neg_cost.to(dt)
    cand_valid = (cand_packed[..., 14] > 0.5) & (C < 0.5 * COST_INVALID)
    cand_slab_idx = cand_packed[..., 16].to(torch.int32)

    # Weight-proportional source marginal with a mean-weight floor.
    a_mask = meas_valid.to(dt)
    w = torch.clamp(meas_weights, min=0.0) * a_mask
    w_mean = torch.sum(w) / torch.clamp(torch.sum(a_mask), min=1.0)
    aw = a_mask * (w + w_mean)
    a = aw / torch.clamp(torch.sum(aw), min=cfg.eps_mass)
    log_a = torch.where(a > 0, torch.log(torch.clamp(a, min=1e-300)),
                        float("-inf"))
    ua = cfg.ot_tau_a / (cfg.ot_tau_a + eps)
    vb = cfg.ot_tau_b / (cfg.ot_tau_b + eps)
    logKT = (-C / eps).T.contiguous()                          # (K, N)
    piT = assoc_kernels.sinkhorn_piT(logKT, log_a, n_iter=cfg.k_sinkhorn,
                                     ua=ua, vb=vb,
                                     log_b=-math.log(float(K)))
    pi = piT.T * a_mask[:, None] * cand_valid.to(dt)

    # Hard per-row mass cap: never transport more than the budget a_i.
    row_raw = torch.sum(pi, 1)
    row_cap = torch.clamp(a / torch.clamp(row_raw, min=cfg.eps_mass),
                          max=1.0)
    pi = pi * row_cap[:, None]
    row_masses = torch.sum(pi, 1)
    col_masses = torch.sum(pi, 0)
    b = torch.exp(torch.full((K,), -math.log(float(K)), dtype=dt,
                             device=pi.device))
    ess_ot = (torch.sum(row_masses) ** 2
              / (torch.sum(row_masses ** 2) + cfg.eps_mass))
    certs = {
        "ot.effect_predicted": torch.sum(a),
        "ot.effect_realized": torch.sum(pi),
        "ot.marginal_defect_a": torch.linalg.norm(row_masses - a),
        "ot.marginal_defect_b": torch.linalg.norm(col_masses - b),
        "ot.transport_mass_total": torch.sum(pi),
        "ot.sum_novel": torch.sum(torch.clamp(a - row_masses, min=0.0)),
        "ot.ess": ess_ot,
        "ot.total_cost": torch.sum(pi * C),
    }
    return AssociationResult(
        responsibilities=pi, cand_view_idx=cand_view_idx,
        cand_slab_idx=cand_slab_idx, cand_valid=cand_valid,
        row_masses=row_masses, cost=C, cand_packed=cand_packed,
        row_budget=a), certs


def novelty_mass(result: AssociationResult):
    """max(a - transported row mass, 0) with the plan's source marginal."""
    return torch.clamp(result.row_budget - result.row_masses, min=0.0)
