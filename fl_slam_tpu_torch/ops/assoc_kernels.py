"""The association kernels: K3, the log-domain unbalanced Sinkhorn fixed
point (port of the TPU kernel ``fl_slam_tpu/ops/assoc_kernels.py:77``
``sinkhorn_piT``), and K9, the fused candidate selection (``:255`` stage 1
and ``:272`` stage 2 of ``select_candidates``).

``sinkhorn_piT`` is a ``torch.library.custom_op``: it launches the
hand-written CUDA kernel (``csrc/sinkhorn.cu``, the Pallas kernel's
finite-cap form, one cluster of 8 CTAs per instance; ``sinkhorn_plan``
sizes it) for CUDA tensors and runs the plain version
(``sinkhorn_piT_plain``, the reference's XLA form with -inf rows) for CPU
tensors; any other device, or a shape the kernel cannot hold, raises.
``select_candidates`` builds the proxy cost's two factors in torch and
hands them to the op behind K9 (``csrc/select.cu``, the chunks' top 2 and
then the top k, two kernels of one call; ``select_plan`` sizes them; plain
version ``select_topk_plain``) the same way. Their instance-batching rules
(``register_vmap``) launch the kernel once for all instances under
``torch.func.vmap`` (the reference gets that batching from its grid).
``launches`` counts kernel launches, one-instance and batched apart.
"""

from __future__ import annotations

import torch

from fl_slam_tpu_torch import cuda_build
from fl_slam_tpu_torch.runtime import instance_first

_NEG_CAP = -1e30
_LOG_ZERO = -3e38
launches = {"sinkhorn_piT": 0, "sinkhorn_piT_batched": 0}
_CLUSTER = 8          # CTAs per instance
_MAX_THREADS = 256    # threads per CTA
_MAX_CPT = 4          # columns per thread (kernel templates 1, 2, 4)


def sinkhorn_plan(K: int, N: int, itemsize: int) -> dict:
    """The kernel's launch plan for one instance: a cluster of 8 CTAs
    splits the N columns (``cols_per_cta`` each); a thread keeps
    ``cols_per_thread`` columns' K potentials in registers (at most 64
    32-bit registers of them), ``threads`` per CTA. ``smem_bytes`` is the
    CTA's shared memory (the warp partials, and the cluster's CTA partials
    by iteration parity). Raises, naming
    shared memory, for what the kernel cannot hold."""
    km = 8 if K <= 8 else 16 if K <= 16 else 32
    words = km * (itemsize // 4)
    cpt_max = min(_MAX_CPT, max(1, 64 // words))
    max_n = _CLUSTER * _MAX_THREADS * cpt_max
    if not 1 <= K <= 32 or N > max_n:
        raise ValueError(
            f"sinkhorn_piT: K={K}, N={N} does not fit the kernel's registers "
            f"and shared memory (K <= 32, N <= {max_n} at this K and dtype)")
    cpc = -(-N // _CLUSTER)
    cpt = 1
    while cpt < cpt_max and cpc > cpt * _MAX_THREADS:
        cpt *= 2
    threads = min(_MAX_THREADS, max(32, -(-(-(-cpc // cpt)) // 32) * 32))
    warps = _MAX_THREADS // 32
    return {"cluster": _CLUSTER, "threads": threads, "cols_per_thread": cpt,
            "cols_per_cta": cpc, "k_max": km, "max_n": max_n,
            "smem_bytes": (2 * warps + 4 * _CLUSTER) * km * itemsize}


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
    """The kernel on (B, K, N) ``logKT`` and (B, N) ``log_a``: one cluster
    per instance."""
    if logKT.device.type != "cuda":
        raise ValueError(f"sinkhorn_piT: unsupported device {logKT.device}")
    B, K, N = logKT.shape
    if tuple(log_a.shape) != (B, N) or log_a.device != logKT.device:
        raise ValueError(f"sinkhorn_piT: log_a {tuple(log_a.shape[1:])} does "
                         f"not match logKT {tuple(logKT.shape[1:])}")
    if logKT.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sinkhorn_piT: dtype {logKT.dtype}")
    plan = sinkhorn_plan(K, N, logKT.element_size())
    logKT = logKT.contiguous()
    la = torch.nan_to_num(log_a.to(logKT.dtype), nan=_LOG_ZERO,
                          neginf=_LOG_ZERO, posinf=0.0).contiguous()
    piT = torch.empty_like(logKT)
    lib = cuda_build.library("sinkhorn")
    fn = lib.sinkhorn_f32 if logKT.dtype == torch.float32 else \
        lib.sinkhorn_f64
    cuda_build.launch(lib, fn, "sinkhorn_piT", logKT.device, logKT.data_ptr(),
                      la.data_ptr(), piT.data_ptr(), B, K, N, plan["threads"],
                      plan["cols_per_thread"], int(n_iter), float(ua),
                      float(vb), float(log_b))
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


# ---------------------------------------------------------------------------
# K9, the fused candidate selection (port of the TPU kernel
# ``fl_slam_tpu/ops/assoc_kernels.py:255`` ``select_candidates``, stage 1
# ``_select_chunk_body`` and stage 2 ``:272`` ``_select_topk_body``).
# ---------------------------------------------------------------------------

_COST_INVALID_K = 1.0e6
_CHUNK = 128
launches.update({"select_candidates": 0, "select_candidates_batched": 0})


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


_SMEM_MAX = 232448    # dynamic shared memory a block may use (H100)
# The layout of csrc/select.cu: kTopkWarps, kRowsPerLane, and each dtype's
# column stride in the staged chunk (Quad<T>::kStride values).
_TOPK_WARPS = 4
_SELECT_ROWS_PER_LANE = 2
_SELECT_STRIDE = {4: 20, 8: 18}


def select_plan(N: int, V: int, k: int, itemsize: int, B: int = 1) -> dict:
    """K9's launch plan; the wrapper passes its ``grid``, ``lanes``,
    ``topk_grid`` and ``smem_bytes`` to the entry point, which launches from
    them. Stage 1 (``select_kernel``): one warp per unit, ``units`` =
    ``groups`` of ``rows_per_warp`` rows (``rows_per_lane`` per lane) times
    ``chunks`` of 128 columns per instance (``grid``): block ``u`` scores
    chunk ``u % chunks`` of row group ``u // chunks`` in
    ``smem_bytes[0]``. The survivors, 2 per row and chunk, go to a scratch
    of ``scratch_bytes``. Stage 2 (``select_topk_kernel``): row r on warp
    ``r % 4`` of block ``r // 4`` (``topk_grid``), over ``lanes`` survivors
    (the reference's padding to a multiple of 128) in ``smem_bytes[1]``.
    No cluster. Raises on what the kernel cannot take."""
    if V <= 0 or V % _CHUNK or N <= 0 or k <= 0 or not 1 <= B <= 65535:
        raise ValueError(f"select_candidates: N={N}, V={V}, k={k}, B={B}: "
                         "the kernel takes V a positive multiple of 128, "
                         "N, k > 0 and 1 <= B <= 65535")
    C = V // _CHUNK
    R = _SELECT_ROWS_PER_LANE
    G = -(-N // (32 * R))
    P = -(-2 * C // 128) * 128
    smem = (_CHUNK * _SELECT_STRIDE[itemsize] * itemsize,
            _TOPK_WARPS * P * (itemsize + 4))
    if max(smem) > _SMEM_MAX:
        raise ValueError(f"select_candidates: V={V} needs {max(smem)} B of "
                         f"shared memory per block, more than {_SMEM_MAX}")
    return {"chunks": C, "lanes": P, "rows_per_lane": R,
            "rows_per_warp": 32 * R, "groups": G, "units": G * C,
            "warps": 1, "threads": 32, "cluster": 1, "grid": (G * C, B),
            "topk_grid": (-(-N // _TOPK_WARPS), B),
            "smem_bytes": smem,
            "scratch_bytes": B * N * 2 * C * (itemsize + 4)}


def _select_launch(a, b, k: int, key: str):
    """The kernel on (B, N, 16) ``a`` and (B, 16, V) ``b``: a grid axis over
    the instances."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"select_candidates: unsupported device {a.device}")
    if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
        raise ValueError(f"select_candidates: dtypes {a.dtype}, {b.dtype}")
    B, N, F = a.shape
    V = b.shape[2]
    if b.shape != (B, F, V) or F != 16:
        raise ValueError(f"select_candidates: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    plan = select_plan(N, V, k, a.element_size(), B)
    a = a.contiguous()
    b = b.contiguous()
    sv = torch.empty((B, N, 2 * plan["chunks"]), dtype=a.dtype,
                     device=a.device)
    si = torch.empty((B, N, 2 * plan["chunks"]), dtype=torch.int32,
                     device=a.device)
    vals = torch.empty((B, N, k), dtype=a.dtype, device=a.device)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=a.device)
    lib = cuda_build.library("select")
    fn = lib.select_f32 if a.dtype == torch.float32 else lib.select_f64
    cuda_build.launch(lib, fn, "select_candidates", a.device, a.data_ptr(),
                      b.data_ptr(), sv.data_ptr(), si.data_ptr(),
                      vals.data_ptr(), idx.data_ptr(), B, N, V, k,
                      plan["grid"][0], plan["lanes"], plan["topk_grid"][0],
                      *plan["smem_bytes"])
    launches[key] += 1
    return vals, idx


@torch.library.custom_op("fl_slam::select_topk", mutates_args=())
def _select(a: torch.Tensor, b: torch.Tensor,
            k: int) -> tuple[torch.Tensor, torch.Tensor]:
    if a.device.type == "cpu":
        return select_topk_plain(a, b, k)
    v, i = _select_launch(a[None], b[None], k, "select_candidates")
    return v[0], i[0]


@torch.library.register_vmap("fl_slam::select_topk")
def _select_vmap(info, in_dims, a, b, k):
    B = info.batch_size
    aa = instance_first(B, a, in_dims[0])
    bb = instance_first(B, b, in_dims[1])
    if aa.device.type == "cpu":
        outs = [select_topk_plain(aa[i], bb[i], k) for i in range(B)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs])), (0, 0)
    return _select_launch(aa, bb, k, "select_candidates_batched"), (0, 0)


def select_candidates_plain(meas_pos, meas_dir, meas_kappa, view_packed,
                            scan_seq, *, k: int, cost_beta: float,
                            recency_scale: float):
    """Plain PyTorch twin of ``select_candidates``."""
    a, b = select_operands(meas_pos, meas_dir, meas_kappa, view_packed,
                           scan_seq, cost_beta=cost_beta,
                           recency_scale=recency_scale)
    return select_topk_plain(a, b, int(k))


def select_candidates(meas_pos, meas_dir, meas_kappa, view_packed, scan_seq,
                      *, k: int, cost_beta: float, recency_scale: float):
    """Top-k candidate view rows by the selection proxy cost (K9).

    meas_pos/meas_dir (N, 3), meas_kappa (N,); view_packed (V, >= 16), the
    MapView packed matrix (cols 0:3 pos | 3:6 dir | 6 kappa | 14 valid |
    15 last_supported); scan_seq () int tensor. Returns (neg_cost (N, k) = -cost
    descending, cand_view_idx (N, k) int32). Proxy cost, as the
    ``select_bf16`` branch in the working dtype:
      |x - m|^2 + beta [k_m>0][k_v>0] 0.5 (1 - mu_m . mu_v)
      + recency_scale max(seq - last_supported, 0) + [~valid] 1e6.
    Requires N % 128 == 0 and V % 128 == 0 (``use_select_kernel``). Under
    ``torch.func.vmap`` one launch serves every instance."""
    N, V = meas_pos.shape[0], view_packed.shape[0]
    if N % _CHUNK or V % _CHUNK:
        raise ValueError(f"select_candidates: N={N} and V={V} must be "
                         "multiples of 128")
    if meas_pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"select_candidates: unsupported device "
                         f"{meas_pos.device}")
    a, b = select_operands(meas_pos, meas_dir, meas_kappa, view_packed,
                           scan_seq, cost_beta=cost_beta,
                           recency_scale=recency_scale)
    return _select(a, b, int(k))


def use_select_kernel(enabled: bool, n: int, v: int, k: int = 8) -> bool:
    """The reference's gate: 2 * (v // 128) stage-1 survivors must cover
    the top-k request (the device of the tensors picks kernel or plain
    version)."""
    return (bool(enabled) and n % _CHUNK == 0 and v % _CHUNK == 0
            and 2 * (v // _CHUNK) >= k)
