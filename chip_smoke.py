#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``fl_slam_tpu_torch``) on one
NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without a result):
  1. build the CUDA kernels from ``fl_slam_tpu_torch/csrc`` (one nvcc per
     source, in parallel) and print the build seconds;
  2. print the card's name and power limit (nvidia-smi);
  3. hold each kernel against its plain PyTorch version at production
     shapes, and time kernel, plain version and, where one exists, the
     single PyTorch call computing the same function (``library_ms``):
     K3/K4/K5 in f32; K1/K2 in f32 and f64 on two input sets, seeded SPD
     operands and the operands captured from one scan of a
     ``GCConfig.tpu()`` replay;
  4. replay ``GCConfig.tpu()`` (the belief kernels K1/K2 on) and then
     ``GCConfig.tpu(belief_kernel=False)`` over 100 synthetic
     drifting-odometry scans each (seed 3, 10 chunks), each after a
     one-chunk warm-up: ms/scan, peak memory, ATE of SLAM and of raw
     odometry, each kernel's launch count in that run (counts reset just
     before it) and the host syncs that
     ``torch.cuda.set_sync_debug_mode("warn")`` reports inside the replay;
  5. replay 20 scans of ``GCConfig.tpu()`` twice and require identical
     poses.
Then it prints the ``kernels`` JSON line (launches from the
``GCConfig.tpu()`` replay) and, last, the ``ok`` line.
The script imports nothing of JAX and nothing of ``fl_slam_tpu``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings

N_SCANS = 100
N_RERUN = 20
SEED = 3
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
# K1/K2 tolerances (max |kernel - plain| over max |plain|, per output). f32:
# the JAX package's own device-vs-interpret gates for these kernels
# (tests/test_tpu_kernels.py:95, :144). f64: rounding of reordered sums and
# fused multiply-adds, carried through the 22x22 solves.
BELIEF_TOL = {"predict_evidence": {"float32": 1e-3, "float64": 1e-9},
              "scalar_tail": {"float32": 5e-4, "float64": 1e-9}}
_SYNC_WARNING = "called a synchronizing CUDA operation"


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _device_ms(fn, reps: int = 20) -> float:
    """Device time per call of everything ``fn`` launches (torch.profiler),
    free of the host time between launches that CUDA events also see."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) \
        / 1e3 / reps


def _bound_ms(n_bytes: float, n_ops: float):
    t_b = n_bytes / H100_BYTES_PER_S * 1e3
    t_o = n_ops / H100_F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_kernels() -> list:
    """Phase 3: every kernel of the path against its plain version."""
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.ops import assoc_kernels, surfel_kernels
    from fl_slam_tpu_torch.structures import atlas_kernels
    from fl_slam_tpu_torch.structures.atlas import _cf_padded

    cfg = GCConfig.tpu()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    # K3 Sinkhorn: logKT (K, N) = -C^T / eps, some invalid candidates and
    # some dead source rows, as the association hands it over.
    K, N = cfg.k_assoc, cfg.n_meas
    C = torch.rand((N, K), generator=g, device=dev) * 2.0
    C = torch.where(torch.rand((N, K), generator=g, device=dev) < 0.05,
                    torch.full_like(C, 1e12), C)
    logKT = (-C / cfg.ot_epsilon).T.contiguous()
    a = torch.rand((N,), generator=g, device=dev)
    a = torch.where(torch.rand((N,), generator=g, device=dev) < 0.2,
                    torch.zeros_like(a), a)
    a = a / a.sum()
    log_a = torch.where(a > 0, torch.log(a.clamp(min=1e-300)),
                        torch.full_like(a, float("-inf")))
    eps = cfg.ot_epsilon
    kw = dict(n_iter=cfg.k_sinkhorn, ua=cfg.ot_tau_a / (cfg.ot_tau_a + eps),
              vb=cfg.ot_tau_b / (cfg.ot_tau_b + eps),
              log_b=-math.log(float(K)))
    out_k = assoc_kernels.sinkhorn_piT(logKT, log_a, **kw)
    out_p = assoc_kernels.sinkhorn_piT_plain(logKT, log_a, **kw)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    scale = out_p.abs().max().item()
    tol = 1e-4 * scale + 1e-7      # f32, LSE sums in another order x 50
    if not err <= tol:
        raise AssertionError(f"K3 sinkhorn mismatch {err} > {tol}")
    nb = (2 * K * N + N) * 4
    ops = cfg.k_sinkhorn * K * N * 11
    bound, by = _bound_ms(nb, ops)
    rows.append(dict(
        name="sinkhorn_piT", route="cuda",
        source="fl_slam_tpu_torch/csrc/sinkhorn.cu",
        replaces="fl_slam_tpu/ops/assoc_kernels.py:77",
        site="association", max_abs_err=err, tolerance=tol,
        ms=_time_ms(lambda: assoc_kernels.sinkhorn_piT(logKT, log_a, **kw)),
        plain_ms=_time_ms(lambda: assoc_kernels.sinkhorn_piT_plain(
            logKT, log_a, **kw)),
        bound_ms=bound, bound_by=by, library_ms=None,
        shape=f"logKT ({K}, {N}) f32, {cfg.k_sinkhorn} iterations"))

    # K4 moment segment-sum at both call sites.
    n_cells = cfg.surfel_cells_1 * cfg.surfel_cells_2 * cfg.surfel_cells_z
    V = cfg.n_active_tiles * cfg.m_tile_view
    cf = _cf_padded(cfg.vmf_n_lobes)
    for site, F, Np, Cn in (("surfels", 11, cfg.n_points, n_cells),
                            ("fuse", cf, cfg.n_meas * cfg.k_assoc, V)):
        # Skewed ids, as the path produces them: padding points pile into
        # one cell, and popular view rows draw many candidates.
        pay = torch.randn((F, Np), generator=g, device=dev)
        u = torch.rand((Np,), generator=g, device=dev)
        cell = (u ** 3 * Cn).long().clamp(max=Cn - 1)
        cell = torch.where(torch.rand((Np,), generator=g, device=dev) < 0.2,
                           torch.zeros_like(cell), cell)
        out_k = surfel_kernels.moment_segment_sum(pay, cell, Cn, site=site)
        out_p = surfel_kernels.moment_segment_sum_plain(pay, cell, Cn)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        tol = 1e-5 * out_p.abs().max().item() + 1e-6   # f32 sum order
        if not err <= tol:
            raise AssertionError(f"K4 moment ({site}) mismatch {err} > {tol}")
        zeros = torch.zeros((Cn, F), device=dev)
        payT = pay.T.contiguous()
        bound, by = _bound_ms((F * Np + Np + F * Cn) * 4, F * Np)
        rows.append(dict(
            name=f"moment_segment_sum[{site}]", route="cuda",
            source="fl_slam_tpu_torch/csrc/moment.cu",
            replaces="fl_slam_tpu/ops/surfel_kernels.py:89",
            site=site, max_abs_err=err, tolerance=tol,
            ms=_time_ms(lambda: surfel_kernels.moment_segment_sum(
                pay, cell, Cn, site=site)),
            plain_ms=_time_ms(lambda: surfel_kernels.moment_segment_sum_plain(
                pay, cell, Cn)),
            bound_ms=bound, bound_by=by,
            library_ms=_time_ms(lambda: zeros.clone().index_add_(0, cell,
                                                                 payT)),
            shape=f"payload ({F}, {Np}) f32 into {Cn} cells"))

    # K5 slab exchange: pool (P, CF, M), S resident blocks, old/new slot
    # sets that overlap; refresh 0 and 1.
    P, M, S = cfg.n_tiles_pool, cfg.m_tile, cfg.n_active_tiles
    pool_f = torch.randn((P, cf, M), generator=g, device=dev)
    pool_p = torch.randint(-1, 1 << 20, (P, M), generator=g, device=dev,
                           dtype=torch.int32)
    ff = torch.randn((cf, S * M), generator=g, device=dev)
    fp = torch.randint(-1, 1 << 20, (S * M,), generator=g, device=dev,
                       dtype=torch.int32)
    old = torch.tensor([3, 9, 17, 20, 33, 41, 60], device=dev,
                       dtype=torch.int32)
    new = torch.tensor([9, 5, 17, 62, 41, 0, 3], device=dev,
                       dtype=torch.int32)
    for r in (0, 1):
        flag = torch.tensor(r, device=dev, dtype=torch.int32)
        ins_k = [t.clone() for t in (pool_f, pool_p, ff, fp)]
        ins_p = [t.clone() for t in (pool_f, pool_p, ff, fp)]
        atlas_kernels.conditional_slab_exchange_ff(*ins_k, old, new, flag)
        atlas_kernels.conditional_slab_exchange_ff_plain(*ins_p, old, new,
                                                         flag)
        torch.cuda.synchronize()
        err = max((x.double() - y.double()).abs().max().item()
                  for x, y in zip(ins_k, ins_p))
        if err != 0.0:
            raise AssertionError(f"K5 exchange (refresh={r}) mismatch {err}")
        nb = 4 * S * (cf + 1) * M * 4 if r else 4
        bound, by = _bound_ms(nb, 0)
        rows.append(dict(
            name=f"conditional_slab_exchange_ff[refresh={r}]", route="cuda",
            source="fl_slam_tpu_torch/csrc/slab_exchange.cu",
            replaces="fl_slam_tpu/structures/atlas_kernels.py:353",
            site=f"refresh={r}", max_abs_err=err, tolerance=0.0,
            ms=_time_ms(lambda: atlas_kernels.conditional_slab_exchange_ff(
                *ins_k, old, new, flag)),
            plain_ms=_time_ms(
                lambda: atlas_kernels.conditional_slab_exchange_ff_plain(
                    *ins_p, old, new, flag)),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"pool ({P}, {cf}, {M}) f32, S={S}"))
        del ins_k, ins_p
    return rows


def _seeded_belief_operands(seed: int):
    """K1's 12 and K2's 18 operands (f64, on the CPU): SPD information and
    covariances, unit anchors, the packed vector at the path's magnitudes."""
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.core import se3
    from fl_slam_tpu_torch.ops import noise as noise_ops

    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64

    def spd(n, s=1.0):
        A = torch.randn((n, n), generator=g, dtype=f64)
        return A @ A.T * s + torch.eye(n, dtype=f64)

    def vec(n, s=1.0):
        return torch.randn((n,), generator=g, dtype=f64) * s

    def pose7():
        q = torch.randn((4,), generator=g, dtype=f64)
        return torch.cat([vec(3), q / q.norm()])

    L_prev = spd(22, 10.0)
    sigma = torch.linalg.inv(L_prev + 1e-9 * torch.eye(22, dtype=f64))
    pose_prev = vec(6, 0.1)
    grav = torch.tensor([0.0, 0.0, 9.8], dtype=f64)
    pk = torch.cat([
        torch.tensor([0.1, 100.0, 0.1, 0.005, 0.95, 0.05], dtype=f64),
        pose_prev, vec(3, 0.01), vec(3, 0.01), vec(3, 0.01), vec(3, 0.1),
        vec(3, 0.1) + grav, vec(3, 0.5), vec(3, 0.1), vec(6, 0.1),
        torch.tensor([0.05, 0.02, 0.99], dtype=f64) / 0.9925,
        vec(3, 0.1) + grav, torch.tensor([0.999], dtype=f64), vec(6, 0.05),
        torch.tensor([0.0], dtype=f64)])
    pe = [L_prev, vec(22), pose7(), vec(22, 0.01), 0.5 * (sigma + sigma.T),
          se3.so3_exp(pose_prev[3:6]), spd(22, 0.01), spd(3, 0.001),
          spd(3, 0.01), spd(6, 0.01), spd(3, 0.1), pk]
    cfg = GCConfig.tpu(dtype="float64")
    pn = noise_ops.init_process_noise(cfg, "cpu")
    mn = noise_ops.init_measurement_noise(cfg, "cpu")
    tail = [spd(22, 10.0), vec(22), pose7(), vec(22, 0.01), spd(22, 2.0),
            vec(22), vec(22, 0.01), spd(22), vec(22), vec(6, 0.01), pn.nu,
            pn.psi, mn.nu, mn.psi, spd(3, 0.01), spd(3, 0.01), spd(3, 0.01),
            torch.tensor([100.0, 50.0, 10.0, 0.001, 5.0], dtype=f64)]
    return pe, tail


def _captured_belief_operands(cfg, n_scans: int = 10):
    """The operands K1 and K2 receive on the last scan of a short
    ``GCConfig.tpu()`` replay (copied on the way in)."""
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.ops import belief_kernels
    from fl_slam_tpu_torch.pipeline import init_state, replay

    seen = {}
    pe_fn = belief_kernels.predict_evidence_packed
    tail_fn = belief_kernels.scalar_tail_packed

    def pe_hook(c, *ops):
        seen["pe"] = [t.clone() for t in ops]
        return pe_fn(c, *ops)

    def tail_hook(c, *ops):
        seen["tail"] = [t.clone() for t in ops]
        return tail_fn(c, *ops)

    ds = simulate(cfg, n_scans=n_scans, seed=SEED + 1,
                  odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
    belief_kernels.predict_evidence_packed = pe_hook
    belief_kernels.scalar_tail_packed = tail_hook
    try:
        replay(init_state(cfg, anchor0=ds.gt_poses[0],
                          t0=float(ds.gt_stamps[0]) - 0.1),
               to_scan_inputs(ds, cfg), cfg)
    finally:
        belief_kernels.predict_evidence_packed = pe_fn
        belief_kernels.scalar_tail_packed = tail_fn
    return seen["pe"], seen["tail"]


def _belief_work(name: str, itemsize: int):
    """(bytes, operations) of one call: each input read once and each
    output written once; multiply-adds counted as two operations. The 22x22
    Cholesky is n^3/3, a triangular pair with m right-hand sides 2 n^2 m,
    a matrix product 2 n^3; the scalar SE(3) chain is ~3e3 operations."""
    from fl_slam_tpu_torch.ops import belief_kernels as bk
    n = 22
    chol, solve1 = n ** 3 / 3, 2 * n * n
    if name == "predict_evidence":
        n_in = 7 + 22 + 3 * n * n + 9 * 4 + 36 + bk.PK_LEN
        n_out = bk.out_len(bk.PE_OUT)
        ops = (2 * 2 * n ** 3 + 2 * chol + solve1 * (n + 1)
               + 6 ** 3 / 3 + 2 * 36 * 6 + 4 * solve1 + 12 * n * n + 3e3)
    else:
        n_in = 4 * n * n + 6 * n + 7 + 6 + 7 + 252 + 3 + 27 + 27 + 5
        n_out = bk.out_len(bk.TAIL_OUT)
        ops = (2 * chol + solve1 * (n + 2) + 6 ** 3 / 3 + 2 * 36
               + 3 * solve1 + 14 * n * n + 7 * 36 * 4 + 3e3)
    return (n_in + n_out) * itemsize, ops


def check_belief_kernels() -> list:
    """Phase 3, K1 and K2: kernel against plain version (both on the card)
    in f32 and f64, on seeded and on captured operands."""
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.ops import belief_kernels as bk

    cfg = GCConfig.tpu()
    dev = torch.device("cuda")
    seeded = _seeded_belief_operands(SEED)
    captured = _captured_belief_operands(cfg)
    fns = {"predict_evidence": (bk.predict_evidence_packed, bk.pe_math_plain,
                                0, "fl_slam_tpu/ops/belief_kernels.py:1344"),
           "scalar_tail": (bk.scalar_tail_packed, bk.tail_math_plain, 1,
                           "fl_slam_tpu/ops/belief_kernels.py:676")}
    rows = []
    for name, (kern, plain, k, replaces) in fns.items():
        checks, timed = [], None
        for inputs, ops in (("seeded", seeded[k]), ("captured",
                                                    captured[k])):
            for dt in (torch.float32, torch.float64):
                x = [t.to(dev, dt) for t in ops]
                got = kern(cfg, *x)
                want = plain(cfg, *x)
                torch.cuda.synchronize()
                abs_err = max((a - b).abs().max().item()
                              for a, b in zip(got, want))
                rel_err = max(((a - b).abs().max()
                               / b.abs().max().clamp(min=1e-30)).item()
                              for a, b in zip(got, want))
                finite = all(bool(torch.isfinite(a).all()) for a in got)
                dname = str(dt).replace("torch.", "")
                tol = BELIEF_TOL[name][dname]
                checks.append(dict(inputs=inputs, dtype=dname,
                                   max_abs_err=abs_err, max_rel_err=rel_err,
                                   tolerance=tol))
                if not (finite and rel_err <= tol):
                    raise AssertionError(
                        f"{name} ({inputs}, {dname}) mismatch: relative "
                        f"{rel_err} > {tol} (finite={finite})")
                if inputs == "captured" and dt == torch.float32:
                    timed = x
        nb, ops = _belief_work(name, 4)
        bound, by = _bound_ms(nb, ops)
        main = [c for c in checks if c["inputs"] == "captured"
                and c["dtype"] == "float32"][0]
        rows.append(dict(
            name=name, route="cuda",
            source=f"fl_slam_tpu_torch/csrc/{name}.cu", replaces=replaces,
            site="belief chain", max_abs_err=main["max_abs_err"],
            max_rel_err=main["max_rel_err"], tolerance=main["tolerance"],
            tolerance_is="max |kernel - plain| / max |plain|, per output",
            ms=_time_ms(lambda: kern(cfg, *timed)),
            device_ms=_device_ms(lambda: kern(cfg, *timed)),
            plain_ms=_time_ms(lambda: plain(cfg, *timed), reps=5),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape="22x22 belief, f32 (captured operands)", checks=checks))
    return rows


def _reset_counts():
    from fl_slam_tpu_torch.ops import (assoc_kernels, belief_kernels,
                                       surfel_kernels)
    from fl_slam_tpu_torch.structures import atlas_kernels
    assoc_kernels.launches = 0
    atlas_kernels.launches = 0
    for counts in (surfel_kernels.launches, belief_kernels.launches):
        for k in counts:
            counts[k] = 0


def _read_counts() -> dict:
    from fl_slam_tpu_torch.ops import (assoc_kernels, belief_kernels,
                                       surfel_kernels)
    from fl_slam_tpu_torch.structures import atlas_kernels
    return {"predict_evidence": belief_kernels.launches["predict_evidence"],
            "scalar_tail": belief_kernels.launches["scalar_tail"],
            "sinkhorn_piT": assoc_kernels.launches,
            "moment_segment_sum[surfels]": surfel_kernels.launches["surfels"],
            "moment_segment_sum[fuse]": surfel_kernels.launches["fuse"],
            "conditional_slab_exchange_ff": atlas_kernels.launches}


def _slice(scans, n):
    return type(scans)(*[f[:n] for f in scans])


def run_replay(cfg, label: str, want: dict, ds, scans) -> dict:
    """Phase 4 for one configuration: warm-up chunk, then the counted,
    sync-checked replay of all scans."""
    import numpy as np
    import torch
    from fl_slam_tpu_torch.eval.metrics import ate
    from fl_slam_tpu_torch.pipeline import init_state, replay

    def fresh():
        return init_state(cfg, anchor0=ds.gt_poses[0],
                          t0=float(ds.gt_stamps[0]) - 0.1)

    R = cfg.view_refresh_every
    replay(fresh(), _slice(scans, R), cfg)           # warm-up chunk
    torch.cuda.synchronize()

    state = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            _, out = replay(state, scans, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
    counts = _read_counts()
    syncs = sum(_SYNC_WARNING in str(w.message) for w in caught)
    peak = torch.cuda.max_memory_allocated()
    poses = out.pose.cpu().numpy()
    if not np.isfinite(poses).all():
        raise AssertionError(f"non-finite poses in the {label} replay")
    m = ate(poses, ds.gt_poses, align="initial")
    m_odom = ate(ds.scans["odom_pose"], ds.gt_poses, align="initial")
    for name, n in counts.items():
        if n != want[name]:
            raise AssertionError(f"{label}: {name} launched {n} times in "
                                 f"the main path, expected {want[name]}")
    if syncs:
        raise AssertionError(f"{label}: {syncs} host syncs in the replay")
    for key in ("trans", "rot_deg"):
        if not m[key]["rmse"] < m_odom[key]["rmse"]:
            raise AssertionError(
                f"{label}: SLAM does not beat odometry on {key}: "
                f"{m[key]['rmse']} vs {m_odom[key]['rmse']}")
    result = dict(
        config=label, scans=N_SCANS, chunks=N_SCANS // R,
        ms_per_scan=t_run / N_SCANS * 1e3, peak_mem_bytes=peak,
        ate_trans_m=m["trans"]["rmse"], ate_rot_deg=m["rot_deg"]["rmse"],
        odom_ate_trans_m=m_odom["trans"]["rmse"],
        odom_ate_rot_deg=m_odom["rot_deg"]["rmse"],
        launches=counts, host_syncs_in_replay=syncs)
    print("replay: " + json.dumps(result), flush=True)
    return counts


def main_path() -> dict:
    """Phase 4 + 5: the production replay on the card, both belief
    branches, then the rerun check."""
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.pipeline import init_state, replay

    cfg = GCConfig.tpu()
    t0 = time.perf_counter()
    ds = simulate(cfg, n_scans=N_SCANS, seed=SEED, odom_drift_vel_scale=1.03,
                  odom_drift_yaw_rate=0.01)
    scans = to_scan_inputs(ds, cfg)
    print(f"staging: {time.perf_counter() - t0:.2f} s", flush=True)
    R = cfg.view_refresh_every
    per_scan = {"sinkhorn_piT": N_SCANS,
                "moment_segment_sum[surfels]": N_SCANS,
                "moment_segment_sum[fuse]": N_SCANS,
                "conditional_slab_exchange_ff": N_SCANS // R}
    counts = run_replay(cfg, "GCConfig.tpu()", dict(
        per_scan, predict_evidence=N_SCANS, scalar_tail=N_SCANS), ds, scans)
    run_replay(GCConfig.tpu(belief_kernel=False),
               "GCConfig.tpu(belief_kernel=False)",
               dict(per_scan, predict_evidence=0, scalar_tail=0), ds, scans)

    # Phase 5: two 20-scan replays from fresh states give identical poses.
    def fresh():
        return init_state(cfg, anchor0=ds.gt_poses[0],
                          t0=float(ds.gt_stamps[0]) - 0.1)

    p1 = replay(fresh(), _slice(scans, N_RERUN), cfg)[1].pose
    p2 = replay(fresh(), _slice(scans, N_RERUN), cfg)[1].pose
    same = bool(torch.equal(p1, p2))
    print(f"rerun: GCConfig.tpu(), {N_RERUN} scans twice, identical poses: "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("reruns differ")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from fl_slam_tpu_torch import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the fl_slam_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    from fl_slam_tpu_torch.runtime import configure_numerics
    configure_numerics()

    seconds = cuda_build.build()
    print(f"build: {len(cuda_build.SOURCES)} kernels from "
          f"fl_slam_tpu_torch/csrc in {seconds:.1f} s", flush=True)
    print(_card_line(), flush=True)

    rows = check_kernels() + check_belief_kernels()
    counts = main_path()
    for row in rows:
        name = row["name"]
        key = ("conditional_slab_exchange_ff"
               if name.startswith("conditional_slab_exchange_ff") else name)
        row["launches"] = counts[key]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
