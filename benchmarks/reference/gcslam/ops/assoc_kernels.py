"""The association's two kernel sites in plain PyTorch: the log-domain
unbalanced Sinkhorn fixed point (``sinkhorn_piT``) and the fused candidate
selection (``select_candidates``), each as the reference's XLA form.
Frozen from the port's plain versions; no kernel, no custom op."""

from __future__ import annotations

import torch

_NEG_CAP = -1e30
_LOG_ZERO = -3e38
_COST_INVALID_K = 1.0e6
_CHUNK = 128


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


def select_operands(meas_pos, meas_dir, meas_kappa, view_packed, scan_seq,
                    *, cost_beta: float, recency_scale: float):
    """The bilinear factors of the selection proxy cost, ``cost = a @ b``:
    a (N, 16) = [-2 x | -beta/2 g mu_m | beta/2 g | 1 | |x|^2 | 0...],
    b (16, V) = [m | gv mu_v | gv | |m|^2 + rec + inval | 1 | 0...]."""
    dt = meas_pos.dtype
    N = meas_pos.shape[0]
    V = view_packed.shape[0]
    g = (meas_kappa > 0.0).to(dt)[:, None]
    x2 = torch.sum(meas_pos * meas_pos, -1, keepdim=True)
    a = torch.cat([-2.0 * meas_pos, (-0.5 * cost_beta) * g * meas_dir,
                   (0.5 * cost_beta) * g, torch.ones_like(g), x2,
                   torch.zeros((N, 7), dtype=dt, device=meas_pos.device)], 1)
    vpos = view_packed[:, 0:3]
    gv = (view_packed[:, 6] > 0.0).to(dt)
    m2 = torch.sum(vpos * vpos, -1)
    rec = recency_scale * torch.clamp(scan_seq.to(dt) - view_packed[:, 15],
                                      min=0.0)
    inval = torch.where(view_packed[:, 14] > 0.5, torch.zeros_like(m2),
                        _COST_INVALID_K)
    b = torch.cat([vpos.T, view_packed[:, 3:6].T * gv[None, :], gv[None, :],
                   (m2 + rec + inval)[None, :], torch.ones_like(gv)[None, :],
                   torch.zeros((7, V), dtype=dt, device=view_packed.device)],
                  0)
    return a, b


def select_topk_plain(a, b, k: int):
    """Plain PyTorch version of K9 on the factors: the top-k of
    s = -(a @ b) per row, by the reference's two stages. The product is a
    fixed-order sum of the 16 terms (no fused multiply-add), as the kernel
    takes it. Stage 1 keeps each 128-column chunk's top 2: the lowest
    column at the chunk max, then (every lane at the max removed) the
    lowest column at the next value. Stage 2 takes the top k of those
    survivors, padded with -3e38 to a multiple of 128 lanes (index 0): the
    lowest index among the lanes at the max, every lane at the max
    removed. Returns (vals (N, k), idx (N, k) int32)."""
    N, V = a.shape[0], b.shape[1]
    C = V // _CHUNK
    acc = a[:, 0, None] * b[None, 0, :]
    for j in range(1, a.shape[1]):
        acc = acc + a[:, j, None] * b[None, j, :]
    s = (-acc).reshape(N, C, _CHUNK)
    nbig = torch.tensor(_LOG_ZERO, dtype=s.dtype, device=s.device)
    lane = torch.arange(_CHUNK, device=s.device, dtype=torch.int32)
    big = torch.tensor(1 << 30, dtype=torch.int32, device=s.device)
    mv = s.amax(-1, keepdim=True)
    on = s >= mv
    am = torch.where(on, lane, big).amin(-1, keepdim=True)
    s2 = torch.where(on, nbig, s)
    mv2 = s2.amax(-1, keepdim=True)
    am2 = torch.where(s2 >= mv2, lane, big).amin(-1, keepdim=True)
    base = (torch.arange(C, device=s.device, dtype=torch.int32)
            * _CHUNK)[None, :, None]
    vals = torch.cat([mv, mv2], -1).reshape(N, 2 * C)
    gi = (torch.cat([am, am2], -1) + base).reshape(N, 2 * C)
    P = -(-2 * C // 128) * 128
    vals = torch.nn.functional.pad(vals, (0, P - 2 * C), value=_LOG_ZERO)
    gi = torch.nn.functional.pad(gi, (0, P - 2 * C))
    out_v, out_i = [], []
    for _ in range(k):
        mv = vals.amax(-1, keepdim=True)
        on = vals >= mv
        out_v.append(mv)
        out_i.append(torch.where(on, gi, big).amin(-1, keepdim=True))
        vals = torch.where(on, nbig, vals)
    return torch.cat(out_v, 1), torch.cat(out_i, 1)


def select_candidates_plain(meas_pos, meas_dir, meas_kappa, view_packed,
                            scan_seq, *, k: int, cost_beta: float,
                            recency_scale: float):
    """Plain PyTorch twin of ``select_candidates``."""
    a, b = select_operands(meas_pos, meas_dir, meas_kappa, view_packed,
                           scan_seq, cost_beta=cost_beta,
                           recency_scale=recency_scale)
    return select_topk_plain(a, b, int(k))


def use_select_kernel(enabled: bool, n: int, v: int, k: int = 8) -> bool:
    """The reference's gate: 2 * (v // 128) stage-1 survivors must cover
    the top-k request (the device of the tensors picks kernel or plain
    version)."""
    return (bool(enabled) and n % _CHUNK == 0 and v % _CHUNK == 0
            and 2 * (v // _CHUNK) >= k)


def sinkhorn_piT(logKT, log_a, *, n_iter: int, ua: float, vb: float,
                 log_b: float):
    """Transported-mass matrix piT (K, N) from potentials logKT = -C^T/eps
    and the source log-marginal log_a (N,) (-inf = invalid row)."""
    return sinkhorn_piT_plain(logKT, log_a, n_iter=int(n_iter), ua=float(ua),
                              vb=float(vb), log_b=float(log_b))


def select_candidates(meas_pos, meas_dir, meas_kappa, view_packed, scan_seq,
                      *, k: int, cost_beta: float, recency_scale: float):
    """Top-k candidate view rows by the selection proxy cost: (neg_cost
    (N, k) descending, cand_view_idx (N, k) int32)."""
    return select_candidates_plain(meas_pos, meas_dir, meas_kappa,
                                   view_packed, scan_seq, k=k,
                                   cost_beta=cost_beta,
                                   recency_scale=recency_scale)
