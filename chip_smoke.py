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
     single PyTorch call computing the same function (``library_ms``; for
     K4 and K6 also its device time, ``library_device_ms``, K6's under the
     same ``vmap`` as the kernel): K3 and K4 (both sites) in f32 and f64,
     reruns bit for bit, and at their edges (K3: N not a multiple of the
     cluster's columns, N below the cluster, K = 1, K = 32; K4: every id in
     one cell, every id out of range, N not a multiple of the span, f64 at
     F = 64); K5 in f32; K1/K2 in f32 and f64 on three input sets, seeded
     SPD operands, the operands captured from one scan of a
     ``GCConfig.tpu()`` replay and an edge set (condition number 1e7, the
     first scan of the relative odometry branch, dt = 1e-4 s), reruns bit
     for bit, and their device us per call, one instance and B = 8, beside
     the one-block design's; K1/K2, K3 and K4's fuse site also on the
     operands captured from one camera-on scan (its camera rows live); K6
     and K9 at their edges (K6 at B = 8: the last page of every slab, int32
     offsets, offsets shared by every instance, offsets off the 16-byte
     grid, f64; K9 in f32 and f64: one chunk, V = 16,640, N not a multiple
     of the rows per warp, exact ties across the warps' chunks and row
     groups), reruns bit for bit, and their ms, device us per call, library
     ms and bound beside the previous designs' (K9's bound also at the non-
     FMA instruction rate);
  4. replay ``GCConfig.tpu()`` (the belief kernels K1/K2 on) and then
     ``GCConfig.tpu(belief_kernel=False)`` over 100 synthetic
     drifting-odometry scans each (seed 3, 10 chunks), each after a
     one-chunk warm-up: ms/scan, peak memory, ATE of SLAM and of raw
     odometry, each kernel's launch count in that run (counts reset just
     before it) and the host syncs that
     ``torch.cuda.set_sync_debug_mode("warn")`` reports inside the replay;
  5. replay 20 scans of ``GCConfig.tpu()`` twice and require identical
     poses;
  6. the instance-batched replay (``parallel.replicas.batched_replay``) of
     ``GCConfig.tpu()`` over B = 8 instances of 100 drifting-odometry scans
     (seeds 3-10), after a one-chunk warm-up: aggregate scan-instances/s,
     ms per batched scan, peak memory and the measured peak factor of the
     memory envelope, each instance's ATE against its odometry (each must
     beat it), each kernel's launch count (one per batched call, not B),
     host syncs, the vmap fallback warnings; instance 0 against the
     single-instance ``GCConfig.tpu(insert_page_dense=True)`` replay of the
     same data; then two 20-scan batched reruns with identical poses;
  7. the selection path: ``GCConfig.tpu(select_kernel=True)`` (K9 in the
     association) over phase 4's scans after a one-chunk warm-up: ms/scan,
     ATE against odometry and against phase 4's run without K9, K9's
     launches (one per scan) and host syncs (none);
  8. the map path: replay ``GCConfig.tpu()`` over 100 scans and flush the
     slabs; checkpoint, restore, and replay 20 more scans from the live and
     the restored state (identical poses); write the splat export, the
     runtime manifest and the diagnostics and read them back; render the
     pool's top 16,384 primitives at 960 x 720 with K = 64 under a top-down
     camera through K8's two stages, the binning (stage 1) and the
     compositing (stage 2) (finite, drawn pixels, positive depth where
     covered, one launch of each stage, peak memory below one (T, N) f32
     tensor, a rerun bit for bit; stage 1 equal to ``tile_params`` and
     stage 2 held to ``composite_plain`` on the map; ``render_ms`` split
     by stage); push them through the 15 BEV projections.
  9. the bag path: write a 300-scan Kimera-layout fixture bag at real VLP-16
     density (``n_az`` 1,800: 28,800 raw points a scan) and run the
     evaluation entry point on it, ``eval.run_eval --profile kimera
     --seg-len 100 --stream --gt`` (a staging thread one segment ahead of
     the replay): every audit gate, the native staging backend, 0 host
     syncs inside each segment's replay (the count over the whole streamed
     loop printed), each of K1-K5's launches per scan, ATE and RPE@1m
     inside the fixture's full-metrics bands (0.6 m / 18 deg, 0.35 m / 2.5
     deg), and the streamed poses bit for bit those of one ``replay`` over
     the same staged scans; the staging-included and the replay-only
     scans/s. The fixture's odometry is its ground truth (raw odometry's
     ATE is 0 by construction), so SLAM is not held to beat it here.
 10. the camera path on synthetic RGB-D (320 x 240 frames; native FAST-9
     features fused with the scan's lidar depth into the first n_feat = 512
     of the 1,536 measurement rows): (a) the reference's production claim,
     ``GCConfig.tpu()`` over 200 drifting-odometry scans (seed 0) camera
     off and on, each counted and sync-checked as in phase 4: camera on
     below 0.30 m and 3.0 deg and below 1.5 x camera off + 0.02 m; the
     valid camera rows per scan, the host staging ms a frame, ms/scan,
     K1-K5's launches per scan, and a 20-scan camera-on rerun bit for bit;
     (b) the lidar-degenerate corridor (50 scans, seed 3, odometry 6%
     long) at the reference test's budgets (``GCConfig.small()`` with one
     hypothesis and the paged view): camera on below 0.8 x camera off; the
     same at ``GCConfig.tpu()``, printed; (c) the batched replay camera
     on, B = 8 x 20 scans (seeds 3-10), counted, sync-checked, instance 0
     against the single-instance replay.
 11. the camera from a bag: write a 200-scan Kimera-layout fixture bag with
     the RGB-D camera (``camera=True``: two 424 x 240 JPEG / 16UC1 frames a
     scan, ``n_az`` 1,800, seed 0) and run ``eval.run_eval --profile kimera
     --calib <bag>/fixture_calibration.json --gt --seg-len 100 --stream``
     on it, every frame decoded and its features extracted live in the
     staging thread, then again with the feature sidecar
     (``camera.feature_cache.build_sidecar``): each run checked as phase 9
     (gates, native staging, 0 host syncs inside each segment's replay,
     K1-K5's launches a scan as camera off, ATE and RPE@1m in the bands),
     camera rows in every scan (the valid rows a scan, min and mean), the
     audit naming the sidecar in the second run only, the live run's poses
     bit for bit those of one ``replay`` over the same staged scans, the
     pose gap between the runs printed; K1-K4 held to their plain versions
     on the operands of one camera-on bag scan (phase 3's tolerances); the
     staging ms a scan and the staging-included scans/s beside phase 9's.
Phase 3 also holds the batched launches (K1-K5 at B = 8: K3/K4 batched in
f32 and f64, and K7), K6 and K10, and K8 (960 x 720, K = 64: stage 1 bit
for bit against ``tile_params`` on the seeded scene, at its edges and at
1000 x 700, stage 2 against ``composite_plain``, with the pairs each
stage's data needs and the bounds, dense and from those pairs, at the f32
and the non-FMA rates; device times only from profiles that recorded
each stage's kernels once a call) and K9 (N = 1536, V = 5376, k = 8, also batched at B = 8)
against their plain versions.
Then it prints the ``kernels`` JSON line (launches of the one-instance
kernels from the ``GCConfig.tpu()`` replay of phase 4, of the batched ones
from phase 6, of K9 from phase 7 and of K8 from phase 8) and, last, the
``ok`` line.
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
N_BAG, BAG_SEG, BAG_N_AZ = 300, 100, 1800   # phase 9's fixture and segments
N_CAM_BAG, CAM_BAG_SEG = 200, 100           # phase 11's (seed 0, n_az 1,800)
# test_fixture_full_metrics_gate's bands (tests/test_kimera_layout_parity.py)
BAG_BANDS = {"ate_trans_m": 0.6, "ate_rot_deg": 18.0,
             "rpe1_trans_m": 0.35, "rpe1_rot_deg": 2.5}
N_RERUN = 20
SEED = 3
# Phase 10, the camera path. (a) The reference's production claim
# (tests/test_camera.py:309-333): 200 scans, seed 0, camera on within these
# bounds and within 1.5 x camera off + 0.02 m.
N_CAMERA, CAMERA_SEED = 200, 0
CAMERA_CLAIM = {"ate_trans_m": 0.30, "ate_rot_deg": 3.0}
# (b) The lidar-degenerate corridor (tests/test_camera.py:139-162): 50
# scans, seed 3, odometry 6% long; camera on below 0.8 x camera off. The
# reference runs GCConfig.small(); the port runs it with one hypothesis
# (the reference's bank of 4 is inert) and the paged view.
N_CORRIDOR, CORRIDOR_SEED, CORRIDOR_DRIFT = 50, 3, 1.06
CORRIDOR_CFG = dict(k_hyp=1, view_page=64, surfel_moment_kernel=True,
                    fuse_moment_kernel=True)
# (c) The batched replay camera on: B = N_INST instances of this many scans.
N_CAMERA_BATCHED = 20
N_INST = 8                       # instances per card (the reference's B)
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
# f32 instructions/s outside the tensor cores when no multiply fuses with an
# add (-fmad=false): each product and each sum is its own instruction, so
# half the 67 TFLOP/s counted with fused multiply-adds.
H100_F32_NONFMA_OPS_PER_S = 33.5e12
# K1/K2 tolerances (max |kernel - plain| over max |plain|, per output). f32:
# the JAX package's own device-vs-interpret gates for these kernels
# (tests/test_tpu_kernels.py:95, :144). f64: rounding of reordered sums and
# fused multiply-adds, carried through the 22x22 solves.
BELIEF_TOL = {"predict_evidence": {"float32": 1e-3, "float64": 1e-9},
              "scalar_tail": {"float32": 5e-4, "float64": 1e-9}}
_SYNC_WARNING = "called a synchronizing CUDA operation"
_VMAP_FALLBACK = "There is a performance drop because we have not yet"


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


def _device_ms(fn, reps: int = 20, expect=None, tries: int = 3) -> float:
    """Device time per call of everything ``fn`` launches (torch.profiler),
    free of the host time between launches that CUDA events also see. The
    profile must hold device time and, for each kernel symbol of
    ``expect``, exactly ``expect[symbol]`` launches a call: the profiler
    can record no device time for a call that launches only a port kernel,
    so a profile that misses either is taken again, up to ``tries`` times,
    and then raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
        seen = {k: sum(e.count for e in events if f"::{k}(" in e.key)
                for k in expect or {}}
        if ms > 0 and all(seen[k] == n * reps
                          for k, n in (expect or {}).items()):
            return ms
    raise AssertionError(f"the profiler recorded {ms} device ms per call "
                         f"and launches {seen} for {reps} calls, expected "
                         f"{expect} per call")


def _bound_ms(n_bytes: float, n_ops: float,
              ops_per_s: float = H100_F32_OPS_PER_S):
    t_b = n_bytes / H100_BYTES_PER_S * 1e3
    t_o = n_ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _sinkhorn_operands(cfg, K: int, N: int, g, dev, batch=()):
    """logKT (..., K, N) = -C^T / eps with some invalid candidates, and
    log_a (..., N) with some dead source rows, as the association hands
    them over (f32)."""
    import torch
    C = torch.rand((*batch, N, K), generator=g, device=dev) * 2.0
    C = torch.where(torch.rand(C.shape, generator=g, device=dev) < 0.05,
                    torch.full_like(C, 1e12), C)
    logKT = (-C / cfg.ot_epsilon).transpose(-1, -2).contiguous()
    a = torch.rand((*batch, N), generator=g, device=dev)
    a = torch.where(torch.rand(a.shape, generator=g, device=dev) < 0.2,
                    torch.zeros_like(a), a)
    a = a / a.sum(-1, keepdim=True)
    log_a = torch.where(a > 0, torch.log(a.clamp(min=1e-300)),
                        torch.full_like(a, float("-inf")))
    return logKT, log_a


def _sinkhorn_kw(cfg, K: int) -> dict:
    eps = cfg.ot_epsilon
    return dict(n_iter=cfg.k_sinkhorn, ua=cfg.ot_tau_a / (cfg.ot_tau_a + eps),
                vb=cfg.ot_tau_b / (cfg.ot_tau_b + eps),
                log_b=-math.log(float(K)))


def _moment_operands(F: int, N: int, C: int, g, dev, batch=()):
    """Payload (..., F, N) f32 and skewed ids (..., N), as the path
    produces them: padding points pile into one cell, and popular view rows
    draw many candidates."""
    import torch
    pay = torch.randn((*batch, F, N), generator=g, device=dev)
    u = torch.rand((*batch, N), generator=g, device=dev)
    cell = (u ** 3 * C).long().clamp(max=C - 1)
    cell = torch.where(torch.rand(u.shape, generator=g, device=dev) < 0.2,
                       torch.zeros_like(cell), cell)
    return pay, cell


def _k3_tol(want) -> float:
    """f32: LSE sums in another order x 50 iterations; f64: rounding."""
    import torch
    scale = want.abs().max().item()
    return 1e-4 * scale + 1e-7 if want.dtype == torch.float32 \
        else 1e-10 * scale


def _k4_tol(want) -> float:
    """f32: another summation order; f64: rounding."""
    import torch
    scale = want.abs().max().item()
    return 1e-5 * scale + 1e-6 if want.dtype == torch.float32 \
        else 1e-12 * scale


def _held(what: str, got, want, tol: float, rerun: bool = True,
          **extra) -> dict:
    """Hold a kernel's output against its plain version's (and a rerun
    against the first run, bit for bit); raises on a miss."""
    import torch
    torch.cuda.synchronize()
    err = (got - want).abs().max().item() if want.numel() else 0.0
    dname = str(want.dtype).replace("torch.", "")
    finite = bool(torch.isfinite(got).all())
    if not (finite and err <= tol and rerun):
        raise AssertionError(f"{what} ({dname}, {extra}) mismatch: {err} > "
                             f"{tol}, finite {finite}, rerun identical "
                             f"{rerun}")
    return dict(dtype=dname, max_abs_err=err, tolerance=tol,
                rerun_identical=rerun, **extra)


def _sinkhorn_edges(cfg, g, dev) -> list:
    """K3 where the cluster's split is ragged: N not a multiple of the 8
    CTAs' columns, N below the 8 CTAs, K = 1 and K = 32 (f64 at the plan's
    largest N), f32 and f64."""
    import torch
    from fl_slam_tpu_torch.ops import assoc_kernels
    out = []
    for K, N in ((8, 1537), (8, 5), (1, 1536), (32, 2048)):
        lk, la = _sinkhorn_operands(cfg, K, N, g, dev)
        kw = _sinkhorn_kw(cfg, K)
        for dt in (torch.float32, torch.float64):
            x, y = lk.to(dt), la.to(dt)
            got = assoc_kernels.sinkhorn_piT(x, y, **kw)
            want = assoc_kernels.sinkhorn_piT_plain(x, y, **kw)
            out.append(_held("K3 edge", got, want, _k3_tol(want),
                             rerun=torch.equal(got, assoc_kernels.sinkhorn_piT(
                                 x, y, **kw)), K=K, N=N))
    return out


def _moment_edges(g, dev) -> list:
    """K4 at its edges: every id in one cell, every id out of range, N not
    a multiple of the span, and f64 at F = 64."""
    import torch
    from fl_slam_tpu_torch.ops import surfel_kernels
    out = []
    for case, F, N, C, dt in (("one_cell", 11, 8192, 8192, torch.float32),
                              ("all_out", 32, 12288, 5376, torch.float32),
                              ("ragged", 32, 12288 + 500, 5376,
                               torch.float32),
                              ("f64_F64", 64, 4096 + 77, 2000,
                               torch.float64)):
        pay, cell = _moment_operands(F, N, C, g, dev)
        if case == "one_cell":
            cell = torch.full_like(cell, C // 3)
        elif case == "all_out":
            cell = torch.where(cell % 2 == 0, -1 - cell, cell + C)
        pay = pay.to(dt)
        got = surfel_kernels.moment_segment_sum(pay, cell, C, site="fuse")
        want = surfel_kernels.moment_segment_sum_plain(pay, cell, C)
        rerun = torch.equal(got, surfel_kernels.moment_segment_sum(
            pay, cell, C, site="fuse"))
        if case == "all_out" and got.abs().max().item() != 0.0:
            raise AssertionError("K4 edge: ids out of range were summed")
        out.append(_held("K4 edge", got, want, _k4_tol(want), rerun=rerun,
                         case=case, F=F, N=N, C=C))
    return out


def _camera_checks(cam_ops: dict, n_feat: int) -> dict:
    """K3 and K4 (fuse site) against their plain versions on the operands
    captured from a camera-on scan (f32, as the replay gives them), with
    the camera rows each saw."""
    import torch
    from fl_slam_tpu_torch.ops import assoc_kernels, surfel_kernels
    (lk, la), kw = cam_ops["sinkhorn_piT"]
    got = assoc_kernels.sinkhorn_piT(lk, la, **kw)
    want = assoc_kernels.sinkhorn_piT_plain(lk, la, **kw)
    k3 = _held("K3 sinkhorn (camera-on scan)", got, want, _k3_tol(want),
               rerun=torch.equal(got, assoc_kernels.sinkhorn_piT(lk, la,
                                                                 **kw)),
               inputs="captured camera-on", rows=int(la.numel()),
               live_camera_rows=int(torch.isfinite(la[:n_feat]).sum()))
    (pay, cell, C), kw = cam_ops["moment_segment_sum"]
    got = surfel_kernels.moment_segment_sum(pay, cell, C, **kw)
    want = surfel_kernels.moment_segment_sum_plain(pay, cell, C)
    K = pay.shape[1] // (la.numel())
    k4 = _held("K4 moment (fuse, camera-on scan)", got, want,
               _k4_tol(want), rerun=torch.equal(
                   got, surfel_kernels.moment_segment_sum(pay, cell, C,
                                                          **kw)),
               inputs="captured camera-on", columns=int(pay.shape[1]),
               live_camera_columns=int(
                   (pay[:, :n_feat * K] != 0).any(0).sum()))
    print(f"camera-on operands ({cam_ops['camera_rows']} valid camera rows"
          f" in the scan): K3 {k3['max_abs_err']:.3g} (tolerance "
          f"{k3['tolerance']:.3g}), {k3['live_camera_rows']} live camera "
          f"rows of {k3['rows']}; K4 fuse {k4['max_abs_err']:.3g} "
          f"(tolerance {k4['tolerance']:.3g}), {k4['live_camera_columns']} "
          f"camera columns with mass of {k4['columns']}", flush=True)
    return {"sinkhorn_piT": k3, "moment_segment_sum[fuse]": k4}


def check_kernels(cam_ops: dict) -> list:
    """Phase 3: every kernel of the path against its plain version (K3 and
    K4's fuse site also on the operands of a camera-on scan)."""
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.ops import assoc_kernels, surfel_kernels
    from fl_slam_tpu_torch.structures import atlas_kernels
    from fl_slam_tpu_torch.structures.atlas import _cf_padded

    cfg = GCConfig.tpu()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    camera = _camera_checks(cam_ops, cfg.n_feat)

    # K3 Sinkhorn at the association's shape, f32 and f64 (the kernel's
    # plan and the tolerance by dtype), then its edges.
    K, N = cfg.k_assoc, cfg.n_meas
    logKT, log_a = _sinkhorn_operands(cfg, K, N, g, dev)
    kw = _sinkhorn_kw(cfg, K)
    checks = []
    for dt in (torch.float32, torch.float64):
        x, y = logKT.to(dt), log_a.to(dt)
        out_k = assoc_kernels.sinkhorn_piT(x, y, **kw)
        again = assoc_kernels.sinkhorn_piT(x, y, **kw)
        out_p = assoc_kernels.sinkhorn_piT_plain(x, y, **kw)
        checks.append(_held("K3 sinkhorn", out_k, out_p, _k3_tol(out_p),
                            rerun=torch.equal(out_k, again)))
    checks.append(camera["sinkhorn_piT"])
    nb = (2 * K * N + N) * 4
    ops = cfg.k_sinkhorn * K * N * 11
    bound, by = _bound_ms(nb, ops)
    rows.append(dict(
        name="sinkhorn_piT", launch_key="sinkhorn_piT", route="cuda",
        source="fl_slam_tpu_torch/csrc/sinkhorn.cu",
        replaces="fl_slam_tpu/ops/assoc_kernels.py:77",
        site="association", max_abs_err=checks[0]["max_abs_err"],
        tolerance=checks[0]["tolerance"],
        ms=_time_ms(lambda: assoc_kernels.sinkhorn_piT(logKT, log_a, **kw)),
        device_ms=_device_ms(lambda: assoc_kernels.sinkhorn_piT(
            logKT, log_a, **kw)),
        plain_ms=_time_ms(lambda: assoc_kernels.sinkhorn_piT_plain(
            logKT, log_a, **kw)),
        bound_ms=bound, bound_by=by, library_ms=None,
        plan=assoc_kernels.sinkhorn_plan(K, N, 4),
        shape=f"logKT ({K}, {N}) f32, {cfg.k_sinkhorn} iterations",
        checks=checks, edges=_sinkhorn_edges(cfg, g, dev)))

    # K4 moment segment-sum at both call sites, f32 and f64, then its edges.
    n_cells = cfg.surfel_cells_1 * cfg.surfel_cells_2 * cfg.surfel_cells_z
    V = cfg.n_active_tiles * cfg.m_tile_view
    cf = _cf_padded(cfg.vmf_n_lobes)
    for site, F, Np, Cn in (("surfels", 11, cfg.n_points, n_cells),
                            ("fuse", cf, cfg.n_meas * cfg.k_assoc, V)):
        pay, cell = _moment_operands(F, Np, Cn, g, dev)
        checks = []
        for dt in (torch.float32, torch.float64):
            out_k = surfel_kernels.moment_segment_sum(pay.to(dt), cell, Cn,
                                                      site=site)
            again = surfel_kernels.moment_segment_sum(pay.to(dt), cell, Cn,
                                                      site=site)
            out_p = surfel_kernels.moment_segment_sum_plain(pay.to(dt), cell,
                                                            Cn)
            checks.append(_held(f"K4 moment ({site})", out_k, out_p,
                                _k4_tol(out_p),
                                rerun=torch.equal(out_k, again)))
        if site == "fuse":
            checks.append(camera["moment_segment_sum[fuse]"])
        zeros = torch.zeros((Cn, F), device=dev)
        payT = pay.T.contiguous()
        bound, by = _bound_ms((F * Np + Np + F * Cn) * 4, F * Np)

        def k4():
            return surfel_kernels.moment_segment_sum(pay, cell, Cn, site=site)

        def lib():
            return zeros.clone().index_add_(0, cell, payT)

        rows.append(dict(
            name=f"moment_segment_sum[{site}]",
            launch_key=f"moment_segment_sum[{site}]", route="cuda",
            source="fl_slam_tpu_torch/csrc/moment.cu",
            replaces="fl_slam_tpu/ops/surfel_kernels.py:89",
            site=site, max_abs_err=checks[0]["max_abs_err"],
            tolerance=checks[0]["tolerance"], ms=_time_ms(k4),
            device_ms=_device_ms(k4),
            plain_ms=_time_ms(lambda: surfel_kernels.moment_segment_sum_plain(
                pay, cell, Cn)),
            bound_ms=bound, bound_by=by, library_ms=_time_ms(lib),
            library_device_ms=_device_ms(lib), library="index_add_",
            plan=surfel_kernels.moment_plan(F, Np, Cn, 4),
            shape=f"payload ({F}, {Np}) f32 into {Cn} cells", checks=checks))
    rows[-1]["edges"] = _moment_edges(g, dev)

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
            name=f"conditional_slab_exchange_ff[refresh={r}]",
            launch_key="conditional_slab_exchange_ff", route="cuda",
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


def _rel_err(got, want) -> float:
    return max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
               for a, b in zip(got, want))


def _page_edges(g, dev, cf: int, S: int, M: int, P: int) -> list:
    """K6 at B = N_INST at its edges, gather and write-back against the
    plain version, exactly, each rerun bit for bit: the last page of every
    slab (the last columns of ff), int32 offsets, one set of offsets shared
    by every instance (an instance stride of 0), offsets that are not a
    multiple of 16 bytes (the scalar loop), and f64; one launch per call."""
    import torch
    from fl_slam_tpu_torch.structures import atlas_kernels as ak
    vmap = torch.func.vmap
    B, npg = N_INST, M // P
    base = torch.arange(S, device=dev) * M
    rand = torch.randint(0, npg, (B, S), generator=g, device=dev) * P
    cases = (("last_page", base + (npg - 1) * P + 0 * rand, torch.float32),
             ("int32", (base + rand).to(torch.int32), torch.float32),
             ("shared_offsets", base + rand[0], torch.float32),
             ("unaligned", base + rand + 3 * (rand < (npg - 1) * P),
              torch.float32),
             ("f64", base + rand, torch.float64))
    out = []
    for case, offs, dt in cases:
        ff = torch.randn((B, cf, S * M), generator=g, device=dev).to(dt)
        upd = torch.randn((B, cf, S * P), generator=g, device=dev).to(dt)
        o_dim = None if offs.dim() == 1 else 0
        ob = offs.expand(B, S) if o_dim is None else offs

        def gather():
            return vmap(lambda f, o: ak.page_gather_ff(f, o, P),
                        in_dims=(0, o_dim))(ff, offs)

        n0 = ak.launches["page_gather"]
        got = gather()
        launched = ak.launches["page_gather"] - n0
        want = torch.stack([ak.page_gather_ff_plain(ff[b], ob[b], P)
                            for b in range(B)])
        ff_k, ff_p = ff.clone(), ff.clone()
        vmap(lambda f, o, x: ak.page_writeback_ff(f, o, x, P),
             in_dims=(0, o_dim, 0))(ff_k, offs, upd)
        for b in range(B):
            ak.page_writeback_ff_plain(ff_p[b], ob[b], upd[b], P)
        ff_k2 = ff.clone()
        vmap(lambda f, o, x: ak.page_writeback_ff(f, o, x, P),
             in_dims=(0, o_dim, 0))(ff_k2, offs, upd)
        if launched != 1:
            raise AssertionError(f"K6 edge {case}: {launched} launches")
        row = _held("K6 gather edge", got, want, 0.0,
                    rerun=torch.equal(got, gather()), case=case,
                    offsets=str(offs.dtype).replace("torch.", ""))
        wb = _held("K6 write-back edge", ff_k, ff_p, 0.0,
                   rerun=torch.equal(ff_k, ff_k2))
        row["writeback_max_abs_err"] = wb["max_abs_err"]
        out.append(row)
    return out


def check_batched_kernels() -> list:
    """Phase 3, the batched launches at B = N_INST (one kernel for all
    instances under ``torch.func.vmap``: K3/K4 batched, K7 for K1/K2 and the
    exchange), K6 and K10, each against its plain version per instance; each
    batched instance must also equal the one-instance launch exactly."""
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.ops import assoc_kernels, surfel_kernels
    from fl_slam_tpu_torch.ops import belief_kernels as bk
    from fl_slam_tpu_torch.structures import atlas_kernels as ak
    from fl_slam_tpu_torch.structures.atlas import _cf_padded

    vmap = torch.func.vmap
    cfg = GCConfig.tpu()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    B = N_INST
    rows = []

    def same_as_single(got, one, what):
        if not torch.equal(got, one):
            raise AssertionError(f"{what}: a batched instance differs from "
                                 "the one-instance launch")

    # K3 batched: per-instance costs and source masses, f32 and f64.
    K, N = cfg.k_assoc, cfg.n_meas
    logKT, log_a = _sinkhorn_operands(cfg, K, N, g, dev, batch=(B,))
    kw = _sinkhorn_kw(cfg, K)

    def k3(x=logKT, y=log_a):
        return vmap(lambda p, q: assoc_kernels.sinkhorn_piT(p, q, **kw))(x, y)

    def k3_plain(x=logKT, y=log_a):
        return torch.stack([assoc_kernels.sinkhorn_piT_plain(
            x[b], y[b], **kw) for b in range(B)])

    checks = []
    for dt in (torch.float32, torch.float64):
        x, y = logKT.to(dt), log_a.to(dt)
        out_k, out_p = k3(x, y), k3_plain(x, y)
        same_as_single(out_k[B - 1], assoc_kernels.sinkhorn_piT(
            x[B - 1], y[B - 1], **kw), "K3")
        checks.append(_held("K3 batched", out_k, out_p, _k3_tol(out_p),
                            rerun=torch.equal(out_k, k3(x, y))))
    bound, by = _bound_ms(B * (2 * K * N + N) * 4,
                          B * cfg.k_sinkhorn * K * N * 11)
    rows.append(dict(
        name="sinkhorn_piT[batched]", launch_key="sinkhorn_piT[batched]",
        route="cuda", source="fl_slam_tpu_torch/csrc/sinkhorn.cu",
        replaces="fl_slam_tpu/ops/assoc_kernels.py:77", site=f"B={B}",
        max_abs_err=checks[0]["max_abs_err"],
        tolerance=checks[0]["tolerance"], ms=_time_ms(k3),
        device_ms=_device_ms(k3), plain_ms=_time_ms(k3_plain, reps=3),
        bound_ms=bound, bound_by=by, library_ms=None,
        shape=f"logKT ({B}, {K}, {N}) f32, {cfg.k_sinkhorn} iterations",
        checks=checks))
    del logKT, log_a, out_k, out_p

    # K4 batched at both call sites, skewed ids per instance, f32 and f64.
    n_cells = cfg.surfel_cells_1 * cfg.surfel_cells_2 * cfg.surfel_cells_z
    V = cfg.n_active_tiles * cfg.m_tile_view
    cf = _cf_padded(cfg.vmf_n_lobes)
    for site, F, Np, Cn in (("surfels", 11, cfg.n_points, n_cells),
                            ("fuse", cf, cfg.n_meas * cfg.k_assoc, V)):
        pay, cell = _moment_operands(F, Np, Cn, g, dev, batch=(B,))

        def k4(p=pay):
            return vmap(lambda x, c: surfel_kernels.moment_segment_sum(
                x, c, Cn, site=site))(p, cell)

        def k4_plain(p=pay):
            return torch.stack([surfel_kernels.moment_segment_sum_plain(
                p[b], cell[b], Cn) for b in range(B)])

        checks = []
        for dt in (torch.float32, torch.float64):
            p = pay.to(dt)
            out_k, out_p = k4(p), k4_plain(p)
            same_as_single(out_k[1], surfel_kernels.moment_segment_sum(
                p[1], cell[1], Cn, site=site), f"K4 {site}")
            checks.append(_held(f"K4 batched ({site})", out_k, out_p,
                                _k4_tol(out_p), rerun=torch.equal(out_k,
                                                                  k4(p))))
        zeros = torch.zeros((B * Cn, F), device=dev)
        flat_ids = (cell + Cn * torch.arange(B, device=dev)[:, None]
                    ).reshape(-1)
        payT = pay.transpose(1, 2).reshape(B * Np, F).contiguous()
        bound, by = _bound_ms(B * (F * Np + Np + F * Cn) * 4, B * F * Np)

        def lib():
            return zeros.clone().index_add_(0, flat_ids, payT)

        rows.append(dict(
            name=f"moment_segment_sum[{site},batched]",
            launch_key=f"moment_segment_sum[{site},batched]", route="cuda",
            source="fl_slam_tpu_torch/csrc/moment.cu",
            replaces="fl_slam_tpu/ops/surfel_kernels.py:89",
            site=f"{site}, B={B}", max_abs_err=checks[0]["max_abs_err"],
            tolerance=checks[0]["tolerance"],
            ms=_time_ms(k4), device_ms=_device_ms(k4),
            plain_ms=_time_ms(k4_plain, reps=3), bound_ms=bound,
            bound_by=by, library_ms=_time_ms(lib),
            library_device_ms=_device_ms(lib), library="index_add_",
            shape=f"payload ({B}, {F}, {Np}) f32 into {Cn} cells",
            checks=checks))
        del pay, cell, out_k, out_p, zeros, payT

    # K7 (batched K5) and K10: pools (B, P, CF, M), per-instance slot sets
    # and flags, some clear.
    P, M, S = cfg.n_tiles_pool, cfg.m_tile, cfg.n_active_tiles
    flags = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1][:B], device=dev,
                         dtype=torch.int32)
    n_set = int(flags.sum().item())
    old = torch.stack([torch.randperm(P, generator=g, device=dev)[:S]
                       for _ in range(B)]).to(torch.int32)
    new = torch.stack([torch.randperm(P, generator=g, device=dev)[:S]
                       for _ in range(B)]).to(torch.int32)
    new[:, 0] = old[:, 1]                         # a slot in both sets
    for row_major in (False, True):
        name = ("conditional_slab_exchange" if row_major
                else "conditional_slab_exchange_ff")
        fn = (ak.conditional_slab_exchange if row_major
              else ak.conditional_slab_exchange_ff)
        plain = (ak.conditional_slab_exchange_plain if row_major
                 else ak.conditional_slab_exchange_ff_plain)
        slab = (B, S, cf, M) if row_major else (B, cf, S * M)
        base = [torch.randn((B, P, cf, M), generator=g, device=dev),
                torch.randint(-1, 1 << 20, (B, P, M), generator=g,
                              device=dev, dtype=torch.int32),
                torch.randn(slab, generator=g, device=dev),
                torch.randint(-1, 1 << 20, (B, S, M) if row_major
                              else (B, S * M), generator=g, device=dev,
                              dtype=torch.int32)]
        ins_k = [t.clone() for t in base]
        ins_p = [t.clone() for t in base]

        def k7():
            vmap(fn)(*ins_k, old, new, flags)

        def k7_plain():
            for b in range(B):
                plain(*[t[b] for t in ins_p], old[b], new[b], flags[b])

        k7()
        k7_plain()
        torch.cuda.synchronize()
        err = max((x.double() - y.double()).abs().max().item()
                  for x, y in zip(ins_k, ins_p))
        if err != 0.0:
            raise AssertionError(f"{name} batched mismatch {err}")
        bound, by = _bound_ms(n_set * 4 * S * (cf + 1) * M * 4 + B * 4, 0)
        rows.append(dict(
            name=f"{name}[batched]", launch_key=f"{name}[batched]",
            route="cuda", source="fl_slam_tpu_torch/csrc/slab_exchange.cu",
            replaces=("fl_slam_tpu/structures/atlas_kernels.py:138"
                      if row_major else
                      "fl_slam_tpu/structures/atlas_kernels.py:322"),
            site=f"B={B}, {n_set} flags set", max_abs_err=err,
            tolerance=0.0, ms=_time_ms(k7), device_ms=_device_ms(k7),
            plain_ms=_time_ms(k7_plain, reps=3), bound_ms=bound,
            bound_by=by, library_ms=None,
            shape=f"pool ({B}, {P}, {cf}, {M}) f32, S={S}"))
        if row_major:
            # K10 for one instance, flag set.
            one_k = [t[0].clone() for t in base]
            one_p = [t[0].clone() for t in base]
            one = torch.ones((), device=dev, dtype=torch.int32)
            fn(*one_k, old[0], new[0], one)
            plain(*one_p, old[0], new[0], one)
            torch.cuda.synchronize()
            err = max((x.double() - y.double()).abs().max().item()
                      for x, y in zip(one_k, one_p))
            if err != 0.0:
                raise AssertionError(f"{name} mismatch {err}")
            bound, by = _bound_ms(4 * S * (cf + 1) * M * 4, 0)
            rows.append(dict(
                name=name, launch_key=name, route="cuda",
                source="fl_slam_tpu_torch/csrc/slab_exchange.cu",
                replaces="fl_slam_tpu/structures/atlas_kernels.py:169",
                site="refresh=1", max_abs_err=err, tolerance=0.0,
                ms=_time_ms(lambda: fn(*one_k, old[0], new[0], one)),
                device_ms=_device_ms(lambda: fn(*one_k, old[0], new[0],
                                                one)),
                plain_ms=_time_ms(lambda: plain(*one_p, old[0], new[0], one),
                                  reps=5),
                bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"pool ({P}, {cf}, {M}) f32, slabs ({S}, {cf}, {M})"))
            del one_k, one_p
        del base, ins_k, ins_p
        torch.cuda.empty_cache()

    # K6: the page gather and write-back of the dense-page insert.
    Pg = cfg.view_page
    npg = M // Pg
    ff = torch.randn((B, cf, S * M), generator=g, device=dev)
    offs = (torch.arange(S, device=dev) * M
            + torch.randint(0, npg, (B, S), generator=g, device=dev) * Pg)
    upd = torch.randn((B, cf, S * Pg), generator=g, device=dev)
    cols = (offs[:, :, None] + torch.arange(Pg, device=dev)).reshape(B, 1, -1)
    cols = cols.expand(B, cf, S * Pg)
    nb = 2 * B * cf * S * Pg * 4 + B * S * 4

    def k6g():
        return vmap(lambda f, o: ak.page_gather_ff(f, o, Pg))(ff, offs)

    def k6g_plain():
        return torch.stack([ak.page_gather_ff_plain(ff[b], offs[b], Pg)
                            for b in range(B)])

    def k6g_lib():
        return vmap(lambda f, c: torch.gather(f, 1, c))(ff, cols)

    out_k, out_p = k6g(), k6g_plain()
    if not torch.equal(k6g_lib(), out_p):
        raise AssertionError("K6 gather: the library call computes another "
                             "function")
    same_as_single(out_k[2], ak.page_gather_ff(ff[2], offs[2], Pg), "K6")
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"K6 gather mismatch {err}")
    bound, by = _bound_ms(nb, 0)
    edges = _page_edges(g, dev, cf, S, M, Pg)
    rows.append(dict(
        name="page_gather_ff", launch_key="page_gather_ff", route="cuda",
        source="fl_slam_tpu_torch/csrc/page_io.cu",
        replaces="fl_slam_tpu/structures/atlas_kernels.py:504",
        site=f"B={B}", max_abs_err=err, tolerance=0.0, ms=_time_ms(k6g),
        device_ms=_device_ms(k6g), plain_ms=_time_ms(k6g_plain),
        bound_ms=bound, bound_by=by,
        library_ms=_time_ms(k6g_lib), library_device_ms=_device_ms(k6g_lib),
        library="torch.gather under the same vmap",
        library_unbatched_ms=_time_ms(lambda: torch.gather(ff, 2, cols)),
        shape=f"ff ({B}, {cf}, {S * M}) f32, {S} pages of {Pg}",
        edges=edges))
    ff_k, ff_p, ff_l = ff.clone(), ff.clone(), ff.clone()

    def k6w():
        vmap(lambda f, o, x: ak.page_writeback_ff(f, o, x, Pg))(ff_k, offs,
                                                               upd)

    def k6w_plain():
        for b in range(B):
            ak.page_writeback_ff_plain(ff_p[b], offs[b], upd[b], Pg)

    def k6w_lib():
        vmap(lambda f, c, u: f.scatter_(1, c, u))(ff_l, cols, upd)

    k6w()
    k6w_plain()
    k6w_lib()
    torch.cuda.synchronize()
    err = (ff_k - ff_p).abs().max().item()
    if err != 0.0 or not torch.equal(ff_l, ff_p):
        raise AssertionError(f"K6 write-back mismatch {err} (or the library "
                             "call computes another function)")
    rows.append(dict(
        name="page_writeback_ff", launch_key="page_writeback_ff",
        route="cuda", source="fl_slam_tpu_torch/csrc/page_io.cu",
        replaces="fl_slam_tpu/structures/atlas_kernels.py:542",
        site=f"B={B}", max_abs_err=err, tolerance=0.0, ms=_time_ms(k6w),
        device_ms=_device_ms(k6w), plain_ms=_time_ms(k6w_plain),
        bound_ms=bound, bound_by=by,
        library_ms=_time_ms(k6w_lib), library_device_ms=_device_ms(k6w_lib),
        library="scatter_ under the same vmap",
        library_unbatched_ms=_time_ms(lambda: ff_l.scatter_(2, cols, upd)),
        shape=f"ff ({B}, {cf}, {S * M}) f32, {S} pages of {Pg}"))
    del ff, upd, ff_k, ff_p, ff_l, out_k, out_p

    # K7 of K1/K2: seeded operands per instance, f32 and f64.
    ops = [_seeded_belief_operands(SEED + b) for b in range(B)]
    fns = {"predict_evidence": (bk.predict_evidence_packed, bk.pe_math_plain,
                                0),
           "scalar_tail": (bk.scalar_tail_packed, bk.tail_math_plain, 1)}
    for name, (kern, plain, k) in fns.items():
        checks, timed = [], None
        for dt in (torch.float32, torch.float64):
            x = [torch.stack(xs).to(dev, dt)
                 for xs in zip(*[o[k] for o in ops])]
            got = vmap(lambda *a: kern(cfg, *a))(*x)
            want = [torch.stack(xs) for xs in zip(*[
                plain(cfg, *[t[b] for t in x]) for b in range(B)])]
            one = kern(cfg, *[t[B - 1] for t in x])
            for a_, b_ in zip(got, one):
                same_as_single(a_[B - 1], b_, name)
            torch.cuda.synchronize()
            rel = _rel_err(got, want)
            dname = str(dt).replace("torch.", "")
            tol = BELIEF_TOL[name][dname]
            checks.append(dict(dtype=dname, max_rel_err=rel, tolerance=tol,
                               max_abs_err=max((a_ - b_).abs().max().item()
                                               for a_, b_ in zip(got, want))))
            if not (all(bool(torch.isfinite(t).all()) for t in got)
                    and rel <= tol):
                raise AssertionError(f"{name} batched ({dname}) mismatch: "
                                     f"relative {rel} > {tol}")
            if dt == torch.float32:
                timed = x
        nb, nops = _belief_work(name, 4)
        bound, by = _bound_ms(B * nb, B * nops)
        f32 = checks[0]
        rows.append(dict(
            name=f"{name}[batched]", launch_key=f"{name}[batched]",
            route="cuda", source=f"fl_slam_tpu_torch/csrc/{name}.cu",
            replaces="fl_slam_tpu/ops/belief_kernels.py:621",
            site=f"belief chain, B={B}", max_abs_err=f32["max_abs_err"],
            max_rel_err=f32["max_rel_err"], tolerance=f32["tolerance"],
            tolerance_is="max |kernel - plain| / max |plain|, per output",
            ms=_time_ms(lambda: vmap(lambda *a: kern(cfg, *a))(*timed)),
            device_ms=_device_ms(lambda: vmap(lambda *a: kern(cfg, *a))(
                *timed)),
            plain_ms=_time_ms(lambda: [plain(cfg, *[t[b] for t in timed])
                                       for b in range(B)], reps=2),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"{B} x 22x22 belief, f32 (seeded operands)",
            checks=checks))
    return rows


def _select_work(N: int, V: int, k: int, B: int = 1):
    """(bytes, operations) of K9: a (N, 16) and b (16, V) read once, the
    (N, k) values and indices written once; 16 products and 15 sums and a
    negation per score, 5 comparisons per score for the chunk's top 2, 3
    per survivor lane and pick for the top k. Over 67 TFLOP/s this is the
    ``bound_ms`` column of every PR; over the 33.5 T non-FMA instructions/s
    (``bound_nonfma_ms``) it is the least time of the kernel's separate
    products and sums."""
    P = -(-2 * (V // 128) // 128) * 128
    return (B * (N * 16 + 16 * V + 2 * N * k) * 4,
            B * (N * V * (32 + 5) + N * P * k * 3))


def _composite_work(T: int, K: int, pairs=None):
    """(bytes, operations) of K8 stage 2: the (T, K, 16) rows read once, 4
    planes of T x 1024 pixels written once; 26 f32 operations per pixel and
    splat (the exponent counted as one): all T x 1024 x K pairs (dense), or
    only the ``pairs`` whose logw clears the clip (the work the data
    needs: every other pair's blend is an identity)."""
    n = T * 1024 * K if pairs is None else pairs
    return (T * K * 16 + 4 * T * 1024) * 4, n * 26


def _bin_work(T: int, N: int, K: int, pairs=None):
    """(bytes, operations) of K8 stage 1: the (N, 16) table read once, the
    (T, K, 16) rows written once; 13 f32 operations per (tile, splat) score
    (2 differences, 6 products, 3 sums, the reach comparison, the top-K
    comparison; the scalings by 2 and -0.5, the square root and the mask
    are once per splat) and K per row for the depth ranks. Dense: all T x N
    pairs. From the data: the ``listed_pairs`` of
    ``splat_cases.listed_pairs`` scored, and 3 operations (difference,
    square, comparison) per (tile row, splat) for the row test that lists
    them; every other pair scores -inf without a score."""
    n_ops = T * K * K + (T * N * 13 if pairs is None else
                         pairs["listed_pairs"] * 13 + pairs["row_tests"] * 3)
    return (N * 16 + T * K * 16) * 4, n_ops


def _bits(x):
    import torch
    return x.contiguous().view(torch.int32)


def _bin_held(case: str, table, n_ty: int, n_tx: int, k: int,
              want=None) -> dict:
    """K8 stage 1 on ``table`` against the plain binning (``want``, else
    ``bin_plain`` on the card and on the CPU), every lane bit for bit, and
    a rerun against the first run; raises on a miss."""
    import torch
    from fl_slam_tpu_torch.render import splat_kernels as sk
    got = sk.bin_tiles(table, n_ty, n_tx, k)
    again = sk.bin_tiles(table, n_ty, n_tx, k)
    wants = ([want] if want is not None
             else [sk.bin_plain(table, n_ty, n_tx, k),
                   sk.bin_plain(table.cpu(), n_ty, n_tx, k).to(table.device)])
    torch.cuda.synchronize()
    mism = max(int((_bits(got) != _bits(w)).sum().item()) for w in wants)
    rerun = torch.equal(_bits(got), _bits(again))
    if mism or not rerun:
        raise AssertionError(f"K8 stage 1 {case}: {mism} lanes differ from "
                             f"the plain binning, rerun identical {rerun}")
    return dict(case=case, N=table.shape[0], tiles=n_ty * n_tx, K=k,
                lane_mismatches=mism, rerun_identical=rerun,
                selected_rows=int((got[:, :, 5] > 0).sum().item()))


def _composite_held(case: str, params, n_ty: int, n_tx: int) -> dict:
    """K8 stage 2 against ``composite_plain``: 1e-6 on the colours (the
    kernel's expf against torch's exp), 1e-5 relative on depth where the
    pixel's contribution exceeds 1e-6; a rerun bit for bit."""
    import torch
    from fl_slam_tpu_torch.render import splat_kernels as sk
    got = sk.composite(params, n_ty, n_tx)
    again = sk.composite(params, n_ty, n_tx)
    want = sk.composite_plain(params, n_ty, n_tx)
    held = sk.coverage_plain(params, n_ty, n_tx) > 1e-6
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got[:3], want[:3]))
    zerr = ((got[3][held] - want[3][held]).abs()
            / want[3][held].abs().clamp(min=1e-30)).max().item()
    rerun = all(torch.equal(a, b) for a, b in zip(got, again))
    if not (err <= 1e-6 and zerr <= 1e-5 and held.any() and rerun
            and all(bool(torch.isfinite(a).all()) for a in got)):
        raise AssertionError(f"K8 stage 2 {case}: colors {err} (1e-6), "
                             f"depth {zerr} relative (1e-5), rerun "
                             f"identical {rerun}")
    return dict(case=case, max_abs_err=err, depth_max_rel_err=zerr,
                covered_share=held.float().mean().item(),
                rerun_identical=rerun)


def _k8_edges(dev) -> list:
    """K8 stage 1 at its edges (``splat_cases.bin_edge_table``: exact score
    and depth ties, tiles with fewer than K reaching splats, N < K and
    N < 8, degenerate inverses, -0.0 and 0.0 scores, reach radii at the
    square root's rounding edge), each against the plain binning on the
    card and on the CPU; a seeded scene at 1000 x 700 (no multiple of the
    tile) and one of 40,000 splats (three passes of the kernel's splat
    list) against ``tile_params``; stage 2 on the 40,000-splat rows."""
    import torch
    from fl_slam_tpu_torch.render import splat_kernels as sk
    from fl_slam_tpu_torch.render.splat import bev_camera
    from fl_slam_tpu_torch.render.splat_cases import (BIN_EDGE_CASES,
                                                      bin_edge_table,
                                                      seeded_scene)
    out = []
    cpu = torch.Generator().manual_seed(SEED)
    for case in BIN_EDGE_CASES:
        table, n_ty, n_tx, k = bin_edge_table(case, cpu)
        out.append(_bin_held(case, table.to(dev), n_ty, n_tx, k))
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    for case, n, W, H in (("1000x700", 3000, 1000, 700),
                          ("N40000", 40000, 640, 480)):
        scene = seeded_scene(n, g, dev)
        cam = bev_camera(scene[0].cpu().numpy(), W, H, device=dev)
        want, n_ty, n_tx = sk.tile_params(*scene, cam)
        table = sk.splat_table(*scene, cam)
        out.append(_bin_held(case, table, n_ty, n_tx, want.shape[1],
                             want=want))
    out.append(_composite_held("N40000", want, n_ty, n_tx))
    return out


def _k8_rows(scene, cam, dev) -> list:
    """K8's two stages on a full-width render of ``scene``: stage 1 held to
    ``tile_params`` bit for bit (and at its edges), stage 2 to
    ``composite_plain``; times, bounds (from the pairs this scene needs,
    and dense, each at the f32 rate and the non-FMA rate) and the pairs."""
    from fl_slam_tpu_torch.render import splat_kernels as sk
    from fl_slam_tpu_torch.render.splat_cases import (listed_pairs,
                                                      pair_counts)
    params, n_ty, n_tx = sk.tile_params(*scene, cam)
    table = sk.splat_table(*scene, cam)
    T, K = params.shape[0], params.shape[1]
    N = table.shape[0]
    stage1 = _bin_held("seeded16384", table, n_ty, n_tx, K, want=params)
    stage2 = _composite_held("seeded16384", params, n_ty, n_tx)
    listed = listed_pairs(table, n_ty, n_tx, K)
    pairs = pair_counts(params, n_ty, n_tx)
    shape = f"960x720: {T} tiles of 8x128, N={N}, K={K}, f32"
    nonfma = H100_F32_NONFMA_OPS_PER_S

    def bounds(need, dense):
        b, by = _bound_ms(*need)
        d, dby = _bound_ms(*dense)
        return dict(bound_ms=b, bound_by=by,
                    bound_nonfma_ms=_bound_ms(*need, nonfma)[0],
                    bound_dense_ms=d, bound_dense_by=dby,
                    bound_dense_nonfma_ms=_bound_ms(*dense, nonfma)[0])
    rows = [dict(
        name="splat_bin", launch_key="splat_bin", route="cuda",
        source="fl_slam_tpu_torch/csrc/splat_composite.cu",
        replaces="fl_slam_tpu/render/splat_pallas.py:182",
        also_replaces="fl_slam_tpu/render/splat_pallas.py:124-169 (the "
                      "binning the reference left to XLA)", site="render",
        max_abs_err=0.0, tolerance=0.0, checks=[stage1],
        ms=_time_ms(lambda: sk.bin_tiles(table, n_ty, n_tx, K)),
        device_ms=_device_ms(lambda: sk.bin_tiles(table, n_ty, n_tx, K),
                             expect={"pack_kernel": 1, "bin_kernel": 1}),
        plain_ms=_time_ms(lambda: sk.bin_plain(table, n_ty, n_tx, K),
                          reps=5),
        **bounds(_bin_work(T, N, K, listed), _bin_work(T, N, K)),
        library_ms=None, pairs=listed, shape=shape, edges=_k8_edges(dev))]
    rows.append(dict(
        name="splat_composite", launch_key="splat_composite", route="cuda",
        source="fl_slam_tpu_torch/csrc/splat_composite.cu",
        replaces="fl_slam_tpu/render/splat_pallas.py:182", site="render",
        max_abs_err=stage2["max_abs_err"], tolerance=1e-6,
        depth_max_rel_err=stage2["depth_max_rel_err"], depth_tolerance=1e-5,
        checks=[stage2],
        ms=_time_ms(lambda: sk.composite(params, n_ty, n_tx)),
        device_ms=_device_ms(lambda: sk.composite(params, n_ty, n_tx),
                             expect={"composite_kernel": 1}),
        plain_ms=_time_ms(lambda: sk.composite_plain(params, n_ty, n_tx),
                          reps=5),
        **bounds(_composite_work(T, K, pairs["contributing_pairs"]),
                 _composite_work(T, K)),
        library_ms=None, pairs=pairs, shape=shape))
    return rows


def _select_edges(g, dev) -> list:
    """K9 on the factors at its edges, f32 and f64, values and indices
    exactly the plain version's, each rerun bit for bit: one chunk (V =
    128), V = 16,640 (P = 384 survivor lanes), N not a multiple of the
    plan's rows per warp, and exact ties: duplicated view columns in
    chunks that different warps score, within a chunk, and duplicated
    rows in different row groups."""
    import torch
    from fl_slam_tpu_torch.ops import assoc_kernels as ak
    out = []
    for case, N, V, k in (("one_chunk", 256, 128, 8),
                          ("V16640", 256, 16640, 8),
                          ("ragged_rows", 1000, 5376, 8),
                          ("ties_across_warps", 1536, 5376, 8)):
        for dt in (torch.float32, torch.float64):
            a = torch.randn((N, 16), generator=g, device=dev).to(dt)
            b = torch.randn((16, V), generator=g, device=dev).to(dt)
            if case == "ties_across_warps":
                b[:, 130:140] = b[:, 3:4]         # chunks 0 and 1
                b[:, V - 128:V - 120] = b[:, 3:4]  # and the last chunk
                b[:, 200:228] = b[:, 260:261]     # within and across
                a[700:710] = a[5]                 # rows of other groups
            got = ak._select(a, b, k)
            want = ak.select_topk_plain(a, b, k)
            again = ak._select(a, b, k)
            torch.cuda.synchronize()
            verr = (got[0] - want[0]).abs().max().item()
            mism = int((got[1] != want[1]).sum().item())
            rerun = torch.equal(got[0], again[0]) and torch.equal(
                got[1], again[1])
            dname = str(dt).replace("torch.", "")
            if verr != 0.0 or mism or not rerun:
                raise AssertionError(f"K9 edge {case} ({dname}): values "
                                     f"{verr}, {mism} indices, rerun "
                                     f"identical {rerun}")
            out.append(dict(case=case, N=N, V=V, k=k, dtype=dname,
                            max_abs_err=verr, index_mismatches=mism,
                            rerun_identical=rerun))
    return out


def check_render_select_kernels() -> list:
    """Phase 3, K8 and K9 at the shapes of their paths: K8's two stages on
    the 720 tiles of a 960 x 720 render with K = 64 (a seeded 16,384-splat
    scene under a top-down camera; stage 1 also at its edges), K9 at
    N = 1536, V = 5376, k = 8 (f32 and f64, seeded, with duplicated view
    columns and measurement rows: exact ties) and
    batched at B = N_INST. The kernels round as their plain versions do
    (-fmad=false), so K9 and K8's stage 1 are held exactly and K8's stage 2
    to 1e-6 on the colors (the kernel's expf against torch's exp) and 1e-5
    relative on covered depth."""
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.ops import assoc_kernels as ak
    from fl_slam_tpu_torch.render import splat_kernels as sk
    from fl_slam_tpu_torch.render.splat import bev_camera
    from fl_slam_tpu_torch.render.splat_cases import seeded_scene

    cfg = GCConfig.tpu()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = []

    # K8: the tile pipeline of a full-width render, both stages.
    scene = seeded_scene(16384, g, dev)
    cam = bev_camera(scene[0].cpu().numpy(), 960, 720)
    rows.extend(_k8_rows(scene, cam, dev))
    del scene

    # K9 at GCConfig.tpu()'s selection shape.
    N, V, k = cfg.n_meas, cfg.n_active_tiles * cfg.m_tile_view, cfg.k_assoc
    kw = dict(k=k, cost_beta=0.5,
              recency_scale=cfg.ot_epsilon * cfg.recency_decay_lambda)
    checks, timed = [], None
    for dt in (torch.float32, torch.float64):
        mp = torch.randn((N, 3), generator=g, device=dev, dtype=dt) * 5
        md = torch.nn.functional.normalize(torch.randn(
            (N, 3), generator=g, device=dev, dtype=dt), dim=1)
        mk = torch.rand((N,), generator=g, device=dev, dtype=dt)
        mk[::7] = 0.0
        pk = torch.zeros((V, 19), device=dev, dtype=dt)
        pk[:, 0:3] = torch.randn((V, 3), generator=g, device=dev,
                                 dtype=dt) * 5
        pk[:, 3:6] = torch.nn.functional.normalize(torch.randn(
            (V, 3), generator=g, device=dev, dtype=dt), dim=1)
        pk[:, 6] = torch.rand((V,), generator=g, device=dev, dtype=dt)
        pk[::5, 6] = 0.0
        pk[:, 14] = (torch.rand((V,), generator=g, device=dev) > 0.1).to(dt)
        pk[:, 15] = torch.randint(0, 50, (V,), generator=g,
                                  device=dev).to(dt)
        pk[100:228] = pk[V - 228:V - 100]     # duplicated view columns
        mp[10:20] = mp[9]                     # and measurement rows
        seq = torch.tensor(60, dtype=torch.int32, device=dev)
        v1, i1 = ak.select_candidates(mp, md, mk, pk, seq, **kw)
        v0, i0 = ak.select_candidates_plain(mp, md, mk, pk, seq, **kw)
        torch.cuda.synchronize()
        verr = (v1 - v0).abs().max().item()
        mism = int((i1 != i0).sum().item())
        dname = str(dt).replace("torch.", "")
        checks.append(dict(dtype=dname, max_abs_err=verr,
                           index_mismatches=mism))
        if verr != 0.0 or mism:
            raise AssertionError(f"K9 select ({dname}) mismatch: values "
                                 f"{verr}, {mism} indices")
        if dt == torch.float32:
            timed = ak.select_operands(mp, md, mk, pk, seq,
                                       cost_beta=kw["cost_beta"],
                                       recency_scale=kw["recency_scale"])
            sel = (mp, md, mk, pk, seq)
    # Timed on the factors, as the kernel sees them; with_factors_ms adds
    # the ~20 torch ops that build them (the whole select_candidates call).
    a, b = timed
    bound, by = _bound_ms(*_select_work(N, V, k))
    nonfma, _ = _bound_ms(*_select_work(N, V, k), H100_F32_NONFMA_OPS_PER_S)
    again = ak._select(a, b, k)
    first = ak._select(a, b, k)
    if not (torch.equal(first[0], again[0])
            and torch.equal(first[1], again[1])):
        raise AssertionError("K9: a rerun differs")
    rows.append(dict(
        name="select_candidates", launch_key="select_candidates",
        route="cuda", source="fl_slam_tpu_torch/csrc/select.cu",
        replaces="fl_slam_tpu/ops/assoc_kernels.py:255",
        also_replaces="fl_slam_tpu/ops/assoc_kernels.py:272 (stage 2, "
                      "fused)", site="association (select_kernel)",
        max_abs_err=checks[0]["max_abs_err"], tolerance=0.0,
        ms=_time_ms(lambda: ak._select(a, b, k)),
        device_ms=_device_ms(lambda: ak._select(a, b, k)),
        with_factors_ms=_time_ms(lambda: ak.select_candidates(*sel, **kw)),
        plain_ms=_time_ms(lambda: ak.select_topk_plain(a, b, k)),
        bound_ms=bound, bound_by=by, bound_nonfma_ms=nonfma,
        library_ms=None, plan=ak.select_plan(N, V, k, 4),
        shape=f"a ({N}, 16), b (16, {V}), k={k}, f32", checks=checks,
        edges=_select_edges(g, dev)))

    # K9 batched: one launch for N_INST instances (rows rolled per instance).
    B = N_INST
    A = torch.stack([a.roll(7 * i, 0) for i in range(B)])
    Bm = torch.stack([b.roll(128 * i, 1) for i in range(B)])

    def k9b():
        return torch.func.vmap(lambda x, y: ak._select(x, y, k))(A, Bm)

    vb, ib = k9b()
    one_v, one_i = ak._select(A[B - 1], Bm[B - 1], k)
    if not (torch.equal(vb[B - 1], one_v) and torch.equal(ib[B - 1], one_i)):
        raise AssertionError("K9 batched: an instance differs from the "
                             "one-instance launch")
    errs = []
    for i in range(B):
        pv, pi = ak.select_topk_plain(A[i], Bm[i], k)
        errs.append(max((vb[i] - pv).abs().max().item(),
                        float((ib[i] != pi).sum().item())))
    if max(errs) != 0.0:
        raise AssertionError(f"K9 batched mismatch {max(errs)}")
    again = k9b()
    if not (torch.equal(vb, again[0]) and torch.equal(ib, again[1])):
        raise AssertionError("K9 batched: a rerun differs")
    bound, by = _bound_ms(*_select_work(N, V, k, B))
    nonfma, _ = _bound_ms(*_select_work(N, V, k, B),
                          H100_F32_NONFMA_OPS_PER_S)
    rows.append(dict(
        name="select_candidates[batched]",
        launch_key="select_candidates[batched]", route="cuda",
        source="fl_slam_tpu_torch/csrc/select.cu",
        replaces="fl_slam_tpu/ops/assoc_kernels.py:255",
        also_replaces="fl_slam_tpu/ops/assoc_kernels.py:272 (stage 2, "
                      "fused)", site=f"B={B}", max_abs_err=max(errs),
        tolerance=0.0, ms=_time_ms(k9b), device_ms=_device_ms(k9b),
        plain_ms=_time_ms(lambda: [ak.select_topk_plain(A[i], Bm[i], k)
                                   for i in range(B)], reps=3),
        bound_ms=bound, bound_by=by, bound_nonfma_ms=nonfma,
        library_ms=None,
        shape=f"a ({B}, {N}, 16), b ({B}, 16, {V}), k={k}, f32"))
    del A, Bm, vb, ib
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


def _ill_conditioned_spd(g, n: int, cond: float, scale: float = 1.0):
    """U diag(scale * cond^(-k/(n-1))) U^T (f64, on the CPU): an SPD matrix
    whose eigenvalues spread over ``cond``."""
    import torch
    f64 = torch.float64
    U, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=f64))
    lam = scale * torch.logspace(0.0, -math.log10(cond), n, dtype=f64)
    A = U @ torch.diag(lam) @ U.T
    return 0.5 * (A + A.T)


# The edge set's configuration: the relative odometry branch.
EDGE_CFG = dict(odom_pose_relative=True, odom_pose_mix=0.5,
                odom_pose_rot_scale=0.3)


def _edge_belief_operands(seed: int):
    """K1's and K2's operands at their edges (f64, on the CPU), for
    ``GCConfig.tpu(**EDGE_CFG)``: K1 with a covariance of condition number
    1e7 (its last pivots a few eps_lift above the floor of the lift), the
    first scan of the relative odometry branch and dt = 1e-4 s (the OU
    predict and the preintegration terms nearly vanish); K2 with a prior
    information of condition number 1e7."""
    import torch
    g = torch.Generator().manual_seed(seed)
    pe, tail = _seeded_belief_operands(seed)
    pe = [t.clone() for t in pe]
    tail = [t.clone() for t in tail]
    pe[4] = _ill_conditioned_spd(g, 22, 1e7, 1e-2)   # sigma_prev
    pk = pe[11]
    pk[0] = pk[2] = pk[3] = 1e-4                     # dt_sec, dt_int, dt_imu
    pk[52] = 1.0                                     # first scan
    tail[0] = _ill_conditioned_spd(g, 22, 1e7, 1e7)  # L_pred
    return pe, tail


# Kernel wrappers whose operands ``_captured_operands`` copies (module,
# attribute); K4 only at its fuse site.
_CAPTURED = (("ops.belief_kernels", "predict_evidence_packed"),
             ("ops.belief_kernels", "scalar_tail_packed"),
             ("ops.assoc_kernels", "sinkhorn_piT"),
             ("ops.surfel_kernels", "moment_segment_sum"))


def _capture(run) -> dict:
    """The operands K1, K2, K3 and K4 (fuse site) receive at their last
    call in ``run()`` (copied on the way in): {attribute: (args,
    kwargs)}."""
    import importlib

    import torch

    seen = {}

    def hooked(fn, name):
        def run(*args, **kw):
            if kw.get("site", "fuse") == "fuse":
                seen[name] = ([a.clone() if torch.is_tensor(a) else a
                               for a in args], dict(kw))
            return fn(*args, **kw)
        return run

    mods = [(importlib.import_module(f"fl_slam_tpu_torch.{m}"), name)
            for m, name in _CAPTURED]
    originals = [getattr(m, name) for m, name in mods]
    for (m, name), fn in zip(mods, originals):
        setattr(m, name, hooked(fn, name))
    try:
        run()
    finally:
        for (m, name), fn in zip(mods, originals):
            setattr(m, name, fn)
    return seen


def _captured_operands(cfg, camera: bool, n_scans: int = 20) -> dict:
    """``_capture`` on the last scan of a short ``GCConfig.tpu()`` replay
    of drifting-odometry scans, camera off or on, plus ``camera_rows``
    (valid camera rows of that scan). The view of the first chunk is empty
    (the pool is), so the scan is the second chunk's last."""
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.pipeline import init_state, replay

    ds = simulate(cfg, n_scans=n_scans, seed=SEED + 1, with_camera=camera,
                  odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
    seen = _capture(lambda: replay(
        init_state(cfg, anchor0=ds.gt_poses[0],
                   t0=float(ds.gt_stamps[0]) - 0.1),
        to_scan_inputs(ds, cfg), cfg))
    seen["camera_rows"] = int(ds.scans["cam_valid"][-1].sum())
    return seen


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


def check_belief_kernels(cam_ops: dict) -> list:
    """Phase 3, K1 and K2: kernel against plain version (both on the card)
    in f32 and f64, on seeded operands, operands captured from a camera-off
    and from a camera-on scan (``cam_ops``), and edge operands; reruns bit
    for bit."""
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.ops import belief_kernels as bk

    cfg = GCConfig.tpu()
    cfg_edge = GCConfig.tpu(**EDGE_CFG)
    dev = torch.device("cuda")
    seeded = _seeded_belief_operands(SEED)
    off = _captured_operands(cfg, camera=False)
    captured = [off[k][0][1:] for k in ("predict_evidence_packed",
                                         "scalar_tail_packed")]
    camera = [cam_ops[k][0][1:] for k in ("predict_evidence_packed",
                                          "scalar_tail_packed")]
    edge = _edge_belief_operands(SEED)
    fns = {"predict_evidence": (bk.predict_evidence_packed, bk.pe_math_plain,
                                0, "fl_slam_tpu/ops/belief_kernels.py:1344"),
           "scalar_tail": (bk.scalar_tail_packed, bk.tail_math_plain, 1,
                           "fl_slam_tpu/ops/belief_kernels.py:676")}
    rows = []
    for name, (kern, plain, k, replaces) in fns.items():
        checks, timed = [], None
        for inputs, ops, c in (("seeded", seeded[k], cfg),
                               ("captured", captured[k], cfg),
                               ("captured camera-on", camera[k], cfg),
                               ("edge", edge[k], cfg_edge)):
            for dt in (torch.float32, torch.float64):
                x = [t.to(dev, dt) for t in ops]
                got = kern(c, *x)
                again = kern(c, *x)
                want = plain(c, *x)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{name} ({inputs}): a rerun "
                                         "differs")
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
            name=name, launch_key=name, route="cuda",
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


# Device us per call of the one-block K1 / K2 (512 threads, ~114 / ~70
# block barriers), one instance and B = 8, from this script's phase 3 (NVIDIA
# H100 80GB HBM3, 700.00 W).
ONE_BLOCK_DEVICE_US = {"predict_evidence": (91.0, 80.0),
                       "scalar_tail": (92.0, 81.0)}


def _print_belief_times(rows) -> None:
    by = {r["name"]: r for r in rows}
    for name, (one, eight) in ONE_BLOCK_DEVICE_US.items():
        print(f"{name}: device us per call {by[name]['device_ms'] * 1e3:.1f} "
              f"(one-block design {one}), B={N_INST} "
              f"{by[name + '[batched]']['device_ms'] * 1e3:.1f} "
              f"(one-block design {eight})", flush=True)


# The designs of K6 (one block per page row), K9 (one warp per row, both
# stages in one kernel) and K8 (one block per tile, every pixel through
# every splat, the binning in torch) before their redesign: ms per call
# (CUDA events), device us per call (torch.profiler; K6's then included an
# int32 cast of the offsets), one instance and B = 8, from this script's
# phase 3 (NVIDIA H100 80GB HBM3, 700.00 W).
PREVIOUS_DESIGN = {"page_gather_ff": (0.456, 3.6), "page_writeback_ff":
                   (0.360, 3.5), "select_candidates": (0.099, 71.0),
                   "select_candidates[batched]": (0.389, 356.0),
                   "splat_composite": (0.079, 74.8)}


def _print_redesign_times(rows) -> None:
    by = {r["name"]: r for r in rows}
    for name, (ms, us) in PREVIOUS_DESIGN.items():
        r = by[name]
        extra = (f", bound at the non-FMA rate {r['bound_nonfma_ms']:.4f} ms"
                 if "bound_nonfma_ms" in r else "")
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.3f}")
        print(f"{name}: {r['ms']:.3f} ms (previous design {ms}), device us "
              f"per call {r['device_ms'] * 1e3:.2f} (previous design {us}), "
              f"library ms {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}){extra}", flush=True)
    for name in ("splat_bin", "splat_composite"):
        r = by[name]
        p = r["pairs"]
        share = (f"listed pairs {p['listed_share']:.4f} of {p['dense_pairs']}"
                 if name == "splat_bin" else
                 f"contributing pairs {p['contributing_share']:.4f} of "
                 f"{p['dense_pairs']}, reaching {p['warp_footprint']} warp "
                 f"footprints {p['reaching_warp_share']:.4f}")
        print(f"{name}: {r['ms']:.3f} ms, device us per call "
              f"{r['device_ms'] * 1e3:.2f}, plain {r['plain_ms']:.3f} ms; "
              f"{share}; bound from the pairs {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}) / non-FMA "
              f"{r['bound_nonfma_ms'] * 1e3:.2f} us, dense "
              f"{r['bound_dense_ms'] * 1e3:.2f} us / non-FMA "
              f"{r['bound_dense_nonfma_ms'] * 1e3:.2f} us", flush=True)


def _counters():
    from fl_slam_tpu_torch.ops import (assoc_kernels, belief_kernels,
                                       surfel_kernels)
    from fl_slam_tpu_torch.render import splat_kernels
    from fl_slam_tpu_torch.structures import atlas_kernels
    return (assoc_kernels.launches, surfel_kernels.launches,
            belief_kernels.launches, atlas_kernels.launches,
            splat_kernels.launches)


# Kernel row name -> (counter dict index, key).
_COUNT_KEYS = {
    "predict_evidence": (2, "predict_evidence"),
    "scalar_tail": (2, "scalar_tail"),
    "sinkhorn_piT": (0, "sinkhorn_piT"),
    "moment_segment_sum[surfels]": (1, "surfels"),
    "moment_segment_sum[fuse]": (1, "fuse"),
    "conditional_slab_exchange_ff": (3, "exchange_ff"),
    "predict_evidence[batched]": (2, "predict_evidence_batched"),
    "scalar_tail[batched]": (2, "scalar_tail_batched"),
    "sinkhorn_piT[batched]": (0, "sinkhorn_piT_batched"),
    "moment_segment_sum[surfels,batched]": (1, "surfels_batched"),
    "moment_segment_sum[fuse,batched]": (1, "fuse_batched"),
    "conditional_slab_exchange_ff[batched]": (3, "exchange_ff_batched"),
    "page_gather_ff": (3, "page_gather"),
    "page_writeback_ff": (3, "page_writeback"),
    "conditional_slab_exchange": (3, "exchange"),
    "conditional_slab_exchange[batched]": (3, "exchange_batched"),
    "select_candidates": (0, "select_candidates"),
    "select_candidates[batched]": (0, "select_candidates_batched"),
    "splat_bin": (4, "splat_bin"),
    "splat_composite": (4, "splat_composite"),
}

_SINGLE_PATH = ("predict_evidence", "scalar_tail", "sinkhorn_piT",
                "moment_segment_sum[surfels]", "moment_segment_sum[fuse]",
                "conditional_slab_exchange_ff")
_SELECT_PATH = ("select_candidates", "select_candidates[batched]")
_RENDER_PATH = ("splat_bin", "splat_composite")


def _reset_counts():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def _read_counts() -> dict:
    c = _counters()
    return {name: c[i][k] for name, (i, k) in _COUNT_KEYS.items()}


def _slice(scans, n):
    return type(scans)(*[f[:n] for f in scans])


def run_replay(cfg, label: str, want: dict, ds, scans,
               beat_odom: bool = True) -> dict:
    """Phase 4 for one configuration: warm-up chunk, then the counted,
    sync-checked replay of all scans (SLAM must beat odometry unless
    ``beat_odom`` is False)."""
    import numpy as np
    import torch
    from fl_slam_tpu_torch.eval.metrics import ate
    from fl_slam_tpu_torch.pipeline import init_state, replay

    def fresh():
        return init_state(cfg, anchor0=ds.gt_poses[0],
                          t0=float(ds.gt_stamps[0]) - 0.1)

    R = cfg.view_refresh_every
    T = scans.scan_start.shape[0]
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
        if n != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {n} times in "
                                 f"the main path, expected "
                                 f"{want.get(name, 0)}")
    if syncs:
        raise AssertionError(f"{label}: {syncs} host syncs in the replay")
    for key in ("trans", "rot_deg") if beat_odom else ():
        if not m[key]["rmse"] < m_odom[key]["rmse"]:
            raise AssertionError(
                f"{label}: SLAM does not beat odometry on {key}: "
                f"{m[key]['rmse']} vs {m_odom[key]['rmse']}")
    result = dict(
        config=label, scans=T, chunks=T // R,
        ms_per_scan=t_run / T * 1e3, peak_mem_bytes=peak,
        ate_trans_m=m["trans"]["rmse"], ate_rot_deg=m["rot_deg"]["rmse"],
        ate_trans_axis_m=m["trans_axis_rmse"],
        odom_ate_trans_m=m_odom["trans"]["rmse"],
        odom_ate_rot_deg=m_odom["rot_deg"]["rmse"],
        launches=counts, host_syncs_in_replay=syncs)
    print("replay: " + json.dumps(result), flush=True)
    return result


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
    main = run_replay(cfg, "GCConfig.tpu()", dict(
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
    main["exchange_refresh_flags"] = _exchange_flags(cfg, fresh(), scans)
    return main, ds, scans


def _exchange_flags(cfg, state, scans) -> list:
    """The refresh flag of each K5 launch of one replay (copied on the
    device as it launches, read once the replay is done): how many of the
    chunk-boundary exchanges move the slabs."""
    from fl_slam_tpu_torch.pipeline import replay
    from fl_slam_tpu_torch.structures import atlas_kernels

    fn = atlas_kernels.conditional_slab_exchange_ff
    flags = []

    def hooked(*args):
        flags.append(args[-1].clone())
        return fn(*args)

    atlas_kernels.conditional_slab_exchange_ff = hooked
    try:
        replay(state, scans, cfg)
    finally:
        atlas_kernels.conditional_slab_exchange_ff = fn
    got = [int(f) for f in flags]
    print(f"exchange: {sum(got)} of {len(got)} K5 launches refresh the "
          f"slabs ({got})", flush=True)
    return got


def _first_scans(shards, n):
    """The first ``n`` scans of batched scan inputs (time is axis 1)."""
    return tuple(type(sc)(*[f[:, :n] for f in sc]) for sc in shards)


def _batched_run(cfg, dss, label: str) -> dict:
    """Stage ``dss`` as one batched input (staging seconds printed), run a
    warm-up chunk, then the counted, sync-checked batched replay of all
    their scans; hold instance 0 against the single-instance
    ``insert_page_dense=True`` replay of the same data (< 1e-3). Returns
    what phases 6 and 10 read and check."""
    import collections
    import re

    import torch
    from fl_slam_tpu_torch import certs
    from fl_slam_tpu_torch.io.synthetic import to_scan_inputs
    from fl_slam_tpu_torch.parallel import replicas
    from fl_slam_tpu_torch.pipeline import init_state, replay

    B, R = len(dss), cfg.view_refresh_every
    t0 = time.perf_counter()
    mesh = replicas.make_mesh()
    scans = replicas.shard_scan_inputs(replicas.stack_instances(
        [to_scan_inputs(ds, cfg) for ds in dss]), mesh)
    print(f"{label} staging on the card: {B} instances in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    anchors = [ds.gt_poses[0] for ds in dss]
    t0s = [float(ds.gt_stamps[0]) - 0.1 for ds in dss]
    run = replicas.batched_replay(cfg, mesh)

    def fresh():
        return replicas.init_states_batched(cfg, B, anchors0=anchors,
                                            t0=t0s, mesh=mesh)

    run(fresh(), _first_scans(scans, R))               # warm-up chunk
    torch.cuda.synchronize()
    states = fresh()
    state_bytes = certs.memory_envelope(cfg, B)["state_bytes"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            _, (out,) = run(states, scans)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    syncs = sum(_SYNC_WARNING in str(w.message) for w in caught)
    fallbacks = collections.Counter(
        (re.findall(r"batching rule for (\S+?)\.? ", str(w.message))
         or ["?"])[0] for w in caught if _VMAP_FALLBACK in str(w.message))
    del states
    cfg1 = cfg.replace(insert_page_dense=True)
    _, one = replay(init_state(cfg1, anchor0=anchors[0], t0=t0s[0]),
                    to_scan_inputs(dss[0], cfg1), cfg1)
    diff0 = (out.pose[0] - one.pose).abs().max().item()
    T = out.pose.shape[1]
    want = {name: 0 for name in counts}
    for name in ("predict_evidence[batched]", "scalar_tail[batched]",
                 "sinkhorn_piT[batched]",
                 "moment_segment_sum[surfels,batched]",
                 "moment_segment_sum[fuse,batched]", "page_gather_ff",
                 "page_writeback_ff"):
        want[name] = T
    want["conditional_slab_exchange_ff[batched]"] = T // R
    for name, n in counts.items():
        if n != want[name]:
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"expected {want[name]}")
    if syncs:
        raise AssertionError(f"{label}: {syncs} host syncs")
    if not diff0 < 1e-3:
        raise AssertionError(f"{label}: instance 0 differs from the single "
                             f"replay by {diff0}")
    return dict(out=out, counts=counts, syncs=syncs, t_run=t_run, peak=peak,
                state_bytes=state_bytes, fallbacks=fallbacks, diff0=diff0,
                run=run, fresh=fresh, scans=scans)


def batched_path() -> dict:
    """Phase 6: the instance-batched replay of ``GCConfig.tpu()``, B =
    N_INST instances of N_SCANS drifting-odometry scans (seeds SEED ..
    SEED + B - 1)."""
    import numpy as np
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.eval.metrics import ate
    from fl_slam_tpu_torch.io.synthetic import simulate

    cfg = GCConfig.tpu()
    B, R = N_INST, cfg.view_refresh_every
    t0 = time.perf_counter()
    dss = [simulate(cfg, n_scans=N_SCANS, seed=SEED + i,
                    odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
           for i in range(B)]
    print(f"batched staging: {B} instances simulated in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    r = _batched_run(cfg, dss, "batched replay")
    out, t_run, fresh = r["out"], r["t_run"], r["fresh"]
    poses = out.pose.cpu().numpy()
    if poses.shape != (B, N_SCANS, 6) or not np.isfinite(poses).all():
        raise AssertionError(f"batched replay: poses {poses.shape}, finite "
                             f"{np.isfinite(poses).all()}")
    inst = []
    for i, ds in enumerate(dss):
        m = ate(poses[i], ds.gt_poses, align="initial")
        mo = ate(ds.scans["odom_pose"], ds.gt_poses, align="initial")
        inst.append(dict(seed=SEED + i, ate_trans_m=m["trans"]["rmse"],
                         ate_rot_deg=m["rot_deg"]["rmse"],
                         odom_ate_trans_m=mo["trans"]["rmse"],
                         odom_ate_rot_deg=mo["rot_deg"]["rmse"]))

    # Two 20-scan batched reruns from fresh states.
    p1 = r["run"](fresh(), _first_scans(r["scans"], N_RERUN))[1][0].pose
    p2 = r["run"](fresh(), _first_scans(r["scans"], N_RERUN))[1][0].pose
    same = bool(torch.equal(p1, p2))
    result = dict(
        config="GCConfig.tpu() batched (insert_page_dense)", instances=B,
        scans=N_SCANS, chunks=N_SCANS // R,
        scan_instances_per_s=B * N_SCANS / t_run,
        ms_per_batched_scan=t_run / N_SCANS * 1e3, peak_mem_bytes=r["peak"],
        state_bytes=r["state_bytes"],
        peak_factor=r["peak"] / (B * r["state_bytes"]),
        instances_ate=inst, launches=r["counts"],
        host_syncs_in_replay=r["syncs"],
        vmap_fallback_warnings=sum(r["fallbacks"].values()),
        vmap_fallback_ops=dict(r["fallbacks"]),
        instance0_vs_single_max_pose_diff=r["diff0"],
        rerun_scans=N_RERUN, rerun_identical=same)
    print("batched: " + json.dumps(result), flush=True)
    for r_ in inst:
        if not (r_["ate_trans_m"] < r_["odom_ate_trans_m"]
                and r_["ate_rot_deg"] < r_["odom_ate_rot_deg"]):
            raise AssertionError(f"batched replay: instance seed "
                                 f"{r_['seed']} does not beat its odometry: "
                                 f"{r_}")
    if not same:
        raise AssertionError("batched reruns differ")
    return r["counts"]


def select_path(main: dict, ds, scans) -> dict:
    """Phase 7: ``GCConfig.tpu(select_kernel=True)`` over the same scans as
    phase 4 (K9 in the association), after a one-chunk warm-up; ATE against
    odometry and against phase 4's run without the kernel."""
    from fl_slam_tpu_torch.config import GCConfig

    cfg = GCConfig.tpu(select_kernel=True)
    R = cfg.view_refresh_every
    want = {"predict_evidence": N_SCANS, "scalar_tail": N_SCANS,
            "sinkhorn_piT": N_SCANS, "moment_segment_sum[surfels]": N_SCANS,
            "moment_segment_sum[fuse]": N_SCANS,
            "conditional_slab_exchange_ff": N_SCANS // R,
            "select_candidates": N_SCANS}
    res = run_replay(cfg, "GCConfig.tpu(select_kernel=True)", want, ds,
                     scans)
    print("select: " + json.dumps(dict(
        ms_per_scan=res["ms_per_scan"],
        ms_per_scan_without_k9=main["ms_per_scan"],
        ate_trans_m=res["ate_trans_m"], ate_rot_deg=res["ate_rot_deg"],
        ate_without_k9=[main["ate_trans_m"], main["ate_rot_deg"]],
        odom_ate=[res["odom_ate_trans_m"], res["odom_ate_rot_deg"]],
        k9_launches=res["launches"]["select_candidates"],
        host_syncs_in_replay=res["host_syncs_in_replay"])), flush=True)
    return res["launches"]


def render_path() -> dict:
    """Phase 8: the map's render, export and checkpoint path. Replay
    ``GCConfig.tpu()`` over N_SCANS drifting-odometry scans and flush the
    slabs; checkpoint, restore, and replay N_RERUN more scans from the live
    and from the restored state (identical poses); write and read back the
    splat export, the runtime manifest and the diagnostics; take the top
    16,384 primitives of the pool and render them at 960 x 720 with K = 64
    (the map viewer's widths) under a top-down camera through K8's two
    stages, once, counted (one launch of each), with its peak memory (below
    one (T, N) f32 tensor) and a rerun bit for bit; hold each stage to its
    plain version on the map, and time the render's pieces apart (wall ms
    until the card is done: the table, stage 1, stage 2); push them
    through the 15 BEV projections."""
    import os
    import tempfile

    import numpy as np
    import torch
    from fl_slam_tpu_torch import checkpoint
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.pipeline import flush_slabs, init_state, replay
    from fl_slam_tpu_torch.render import bev, export, splat, splat_kernels

    cfg = GCConfig.tpu()
    ds = simulate(cfg, n_scans=N_SCANS + N_RERUN, seed=SEED,
                  odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
    scans = to_scan_inputs(ds, cfg)

    def fresh():
        return init_state(cfg, anchor0=ds.gt_poses[0],
                          t0=float(ds.gt_stamps[0]) - 0.1)

    state, out = replay(fresh(), _slice(scans, N_SCANS), cfg)
    state = flush_slabs(state)
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        # Checkpoint and resume.
        path = os.path.join(tmp, "state.npz")
        t0 = time.perf_counter()
        checkpoint.save_state(path, state, cfg=cfg)
        restored = checkpoint.load_state(path, fresh(), cfg=cfg)
        torch.cuda.synchronize()
        result["checkpoint_s"] = time.perf_counter() - t0
        result["checkpoint_bytes"] = os.path.getsize(path)
        same_leaves = all(
            torch.equal(a, b) for a, b in zip(checkpoint._leaves(restored),
                                              checkpoint._leaves(state)))
        tail = type(scans)(*[f[N_SCANS:] for f in scans])
        # The export reads the live state before the resume replays
        # consume both (replay updates its state in place).
        t0 = time.perf_counter()
        arrays = export.save_splat_export(
            os.path.join(tmp, "splat_export.npz"), state.atlas, cfg,
            poses=out.pose, stamps=out.stamp)
        export.save_runtime_manifest(os.path.join(tmp, "manifest.json"),
                                     cfg, extra={"scans": N_SCANS})
        export.save_diagnostics(os.path.join(tmp, "diagnostics.npz"),
                                out.certs, stamps=out.stamp)
        result["export_s"] = time.perf_counter() - t0
        back = np.load(os.path.join(tmp, "splat_export.npz"))
        manifest = json.load(open(os.path.join(tmp, "manifest.json")))
        diag = np.load(os.path.join(tmp, "diagnostics.npz"))
        export_ok = (set(back.files) == set(arrays)
                     and all(np.array_equal(back[k], arrays[k])
                             for k in arrays)
                     and back["positions"].shape[0] > 0
                     and np.isfinite(back["positions"]).all()
                     and back["trajectory"].shape == (N_SCANS, 6)
                     and manifest["backend"] == "cuda"
                     and manifest["device_count"] == torch.cuda.device_count()
                     and manifest["config"]["n_tiles_pool"]
                     == cfg.n_tiles_pool
                     and set(diag.files) == {k.replace("/", "_")
                                             for k in out.certs} | {"stamps"})
        result.update(export_prims=int(back["positions"].shape[0]),
                      export_ok=bool(export_ok))

        # The render: top 16,384 of the pool through K8's two stages at
        # 960 x 720: counted, its peak memory, a rerun, each stage held to
        # its plain version on the map, and the render's split by stage.
        prims = splat.atlas_primitives(state.atlas, cfg, 16384)
        cam = splat.bev_camera(prims[0][prims[5]].cpu().numpy(), 960, 720)
        splat_kernels.render_tiled(*prims, cam)              # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        img, depth = splat_kernels.render_tiled(*prims, cam)
        torch.cuda.synchronize()
        result["render_ms"] = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        img2, depth2 = splat_kernels.render_tiled(*prims, cam)
        params, n_ty, n_tx = splat_kernels.tile_params(*prims, cam)
        T, K = params.shape[0], params.shape[1]
        table = splat_kernels.splat_table(*prims, cam)
        stage1 = _bin_held("phase8_map", table, n_ty, n_tx, K, want=params)
        stage2 = _composite_held("phase8_map", params, n_ty, n_tx)

        def wall_ms(fn, reps=5):
            ms = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(ms))
        pieces = {
            "splat_table": wall_ms(
                lambda: splat_kernels.splat_table(*prims, cam)),
            "bin_tiles": wall_ms(
                lambda: splat_kernels.bin_tiles(table, n_ty, n_tx, K)),
            "composite": wall_ms(
                lambda: splat_kernels.composite(params, n_ty, n_tx))}
        cover = splat_kernels.coverage_plain(params, n_ty, n_tx)
        cover = cover.reshape(n_ty, n_tx, 8, 128).permute(0, 2, 1, 3)
        cover = cover.reshape(n_ty * 8, n_tx * 128)[:720, :960]
        drawn = (img < 0.99).any(-1)
        # No (T, N) tensor: the render's peak stays below one (T, N) f32.
        n_prims = prims[0].shape[0]
        render_ok = (img.shape == (720, 960, 3)
                     and bool(torch.isfinite(img).all())
                     and bool(torch.isfinite(depth).all())
                     and bool(drawn.any())
                     and bool((depth[cover > 1e-6] > 0).all())
                     and counts["splat_bin"] == 1
                     and counts["splat_composite"] == 1
                     and peak < T * n_prims * 4
                     and torch.equal(img, img2) and torch.equal(depth, depth2))
        result.update(render_prims=int(prims[5].sum().item()),
                      tiles=T, splats_per_tile=K,
                      drawn_pixel_share=drawn.float().mean().item(),
                      covered_pixel_share=(cover > 1e-6).float().mean()
                      .item(),
                      render_peak_mb=peak / 2 ** 20,
                      render_pieces_ms=pieces, k8_stage1=stage1,
                      k8_stage2=stage2,
                      k8_launches=[counts["splat_bin"],
                                   counts["splat_composite"]],
                      render_ok=render_ok)

        # BEV15 through atlas_bev.
        bev_ok = True
        n = min(16384, cfg.n_tiles_pool * cfg.m_tile)
        for P in bev.bev15_projections():
            mu2, S2, w, rgb = bev.atlas_bev(state.atlas, cfg, P)
            det = S2[:, 0, 0] * S2[:, 1, 1] - S2[:, 0, 1] * S2[:, 1, 0]
            bev_ok &= (mu2.shape == (n, 2) and S2.shape == (n, 2, 2)
                       and bool(torch.isfinite(mu2).all())
                       and bool((det[w > 0] > 0).all()))
        result["bev15_ok"] = bool(bev_ok)

        # Resume: N_RERUN more scans from the live and the restored state.
        p_live = replay(state, tail, cfg)[1].pose
        p_res = replay(restored, tail, cfg)[1].pose
        result["resume_identical"] = bool(same_leaves
                                          and torch.equal(p_live, p_res))
    print("render: " + json.dumps(result), flush=True)
    for key in ("export_ok", "render_ok", "bev15_ok", "resume_identical"):
        if not result[key]:
            raise AssertionError(f"render path: {key} failed: {result}")
    return counts


def _counted_run_eval(argv: list):
    """``eval.run_eval.main(argv)`` with every launch count set to 0 just
    before it and read just after, and the host syncs counted inside each
    segment's replay and over the whole streamed loop (the staging, the
    copies and the segment replays). Returns (run_eval's result, the
    counts, the syncs of each segment's replay, the loop's own syncs)."""
    import torch
    from fl_slam_tpu_torch import pipeline
    from fl_slam_tpu_torch.eval import run_eval

    replay, replay_segments = pipeline.replay, pipeline.replay_segments
    seg_syncs, loop_syncs = [], []

    def counted(fn, into):
        def run(*args, **kwargs):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn(*args, **kwargs)
            into.append(sum(_SYNC_WARNING in str(w.message)
                            for w in caught))
            return out
        return run

    def streamed_loop(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return counted(replay_segments, loop_syncs)(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    pipeline.replay = counted(replay, seg_syncs)
    pipeline.replay_segments = streamed_loop
    torch.cuda.synchronize()
    _reset_counts()
    try:
        res = run_eval.main(argv)
    except SystemExit as e:
        raise AssertionError(f"run_eval {argv} exited {e.code}")
    finally:
        pipeline.replay, pipeline.replay_segments = replay, replay_segments
    return res, _read_counts(), seg_syncs, loop_syncs[0]


def _whole_bag_replay(bag_dir: str, cfg, n: int, cam: dict):
    """One replay over the bag's first ``n`` scans staged as one segment
    by the same stager, from run_eval's anchor: (the staged scans, the
    poses, the replay's seconds, ``init_state``'s keywords)."""
    import torch
    from fl_slam_tpu_torch.io.kimera import KIMERA_TOPICS
    from fl_slam_tpu_torch.io.rosbag import (StreamingStager,
                                             load_scan_records,
                                             smoothed_initial_anchor)
    from fl_slam_tpu_torch.pipeline import init_state, replay

    head = load_scan_records(bag_dir, KIMERA_TOPICS, cfg, max_scans=10)
    (whole,) = list(StreamingStager(bag_dir, KIMERA_TOPICS, cfg, n,
                                    max_scans=n, **cam))
    init = dict(anchor0=smoothed_initial_anchor(head, cfg),
                t0=float(head["scan_start"][0]) - 0.1)
    state = init_state(cfg, **init)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = replay(state, whole, cfg)
    poses = out.pose.cpu().numpy()
    return whole, poses, time.perf_counter() - t0, init


def _bag_result(label: str, res: dict, counts: dict, seg_syncs: list,
                loop_syncs: int, n: int, seg: int, want: dict) -> dict:
    """The numbers of one streamed run_eval on a fixture bag, checked:
    every audit gate, native staging, n scans in n / seg segments, 0 host
    syncs inside each segment's replay, the launch counts ``want``, ATE
    and RPE@1m inside ``BAG_BANDS``."""
    m = res["metrics"]
    stager = res["stager"]
    result = dict(
        scans=m["scans"], segments=len(seg_syncs), seg_len=seg,
        staging_backend=stager.audit["staging_backend"],
        staging_included_scans_per_s=m["scans_per_sec"],
        stage_s_per_segment=stager.stage_s,
        wait_s_per_segment=stager.wait_s,
        staging_ms_per_scan=sum(stager.stage_s) / m["scans"] * 1e3,
        host_syncs_per_segment_replay=seg_syncs,
        host_syncs_streamed_loop=loop_syncs + sum(seg_syncs),
        gates=res["gates"],
        ate_trans_m=m["ate"]["trans"]["rmse"],
        ate_rot_deg=m["ate"]["rot_deg"]["rmse"],
        rpe1_trans_m=m["rpe_1m"]["trans"]["rmse"],
        rpe1_rot_deg=m["rpe_1m"]["rot_deg"]["rmse"],
        odom_ate_trans_m=m["ate_raw_odom"]["trans"]["rmse"],
        odom_ate_rot_deg=m["ate_raw_odom"]["rot_deg"]["rmse"],
        launches={k: v for k, v in counts.items() if v})
    if not all(res["gates"].values()):
        raise AssertionError(f"{label}: gates {res['gates']}")
    if result["staging_backend"] != "native":
        raise AssertionError(f"{label}: staging did not run natively")
    if result["scans"] != n or len(seg_syncs) != n // seg:
        raise AssertionError(f"{label}: {result['scans']} scans in "
                             f"{len(seg_syncs)} segments")
    if any(seg_syncs):
        raise AssertionError(f"{label}: host syncs inside the segment "
                             f"replays: {seg_syncs}")
    for name, k in counts.items():
        if k != want.get(name, 0):
            raise AssertionError(f"{label}: {name} launched {k} times, "
                                 f"expected {want.get(name, 0)}")
    for key, limit in BAG_BANDS.items():
        if not result[key] < limit:
            raise AssertionError(f"{label}: {key} {result[key]} is not "
                                 f"below {limit}")
    return result


def _bag_launches(cfg, n: int) -> dict:
    return {"predict_evidence": n, "scalar_tail": n, "sinkhorn_piT": n,
            "moment_segment_sum[surfels]": n, "moment_segment_sum[fuse]": n,
            "conditional_slab_exchange_ff": n // cfg.view_refresh_every}


def bag_path() -> dict:
    """Phase 9: the evaluation entry point on a Kimera-layout fixture bag
    (staging included), against a monolithic replay of the same staged
    scans. Returns the phase's numbers (the streamed run's launch counts
    among them)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.kimera import make_kimera_fixture_bag

    cfg = GCConfig.tpu()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bag_")
    try:
        t0 = time.perf_counter()
        bag_dir, gt = make_kimera_fixture_bag(
            os.path.join(tmp, "bag"), n_scans=N_BAG, seed=0, n_az=BAG_N_AZ)
        bag_s = time.perf_counter() - t0
        res, counts, seg_syncs, loop_syncs = _counted_run_eval([
            "--out", os.path.join(tmp, "eval"), "--bag", bag_dir,
            "--profile", "kimera", "--gt", gt, "--scans", str(N_BAG),
            "--seg-len", str(BAG_SEG), "--stream"])
        _, mono, replay_s, _ = _whole_bag_replay(bag_dir, cfg, N_BAG, {})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = _bag_result("bag path", res, counts, seg_syncs, loop_syncs,
                         N_BAG, BAG_SEG, _bag_launches(cfg, N_BAG))
    result.update(raw_points_per_scan=16 * BAG_N_AZ, bag_build_s=bag_s,
                  replay_only_scans_per_s=N_BAG / replay_s,
                  streamed_equals_monolithic=bool(
                      np.array_equal(res["poses"], mono)))
    print("bag: " + json.dumps(result), flush=True)
    print(f"bag: staging included {result['staging_included_scans_per_s']:.2f}"
          f" scans/s, replay only {result['replay_only_scans_per_s']:.2f} "
          f"scans/s; host syncs over the streamed loop "
          f"{result['host_syncs_streamed_loop']}", flush=True)
    if not result["streamed_equals_monolithic"]:
        raise AssertionError("bag path: the streamed poses differ from one "
                             "replay of the same staged scans")
    return result


def _belief_held(ops: dict, label: str) -> dict:
    """K1 and K2 against their plain versions (f32, both on the card) on
    captured operands, at phase 3's tolerances."""
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.ops import belief_kernels as bk
    cfg = GCConfig.tpu()
    out = {}
    for name, kern, plain in (
            ("predict_evidence", bk.predict_evidence_packed,
             bk.pe_math_plain),
            ("scalar_tail", bk.scalar_tail_packed, bk.tail_math_plain)):
        x = ops[name + "_packed"][0][1:]
        got, want = kern(cfg, *x), plain(cfg, *x)
        torch.cuda.synchronize()
        rel = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                  .item() for a, b in zip(got, want))
        tol = BELIEF_TOL[name]["float32"]
        if not (all(bool(torch.isfinite(a).all()) for a in got)
                and rel <= tol):
            raise AssertionError(f"{name} ({label}) mismatch: relative "
                                 f"{rel} > {tol}")
        out[name] = dict(max_rel_err=rel, tolerance=tol)
    return out


def camera_bag_path(bag_off: dict) -> dict:
    """Phase 11: the camera from a bag. A 200-scan Kimera-layout fixture
    written with the RGB-D camera; ``run_eval --profile kimera --calib``
    streamed in segments of 100, live decode and extraction (run 1), then
    again with the feature sidecar (run 2); K1-K4 held to their plain
    versions on one camera-on bag scan's operands. ``bag_off``: phase 9's
    numbers (camera off), printed beside. Returns the phase's numbers."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from fl_slam_tpu_torch.camera.feature_cache import build_sidecar
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.kimera import (KIMERA_CAM_TOPICS,
                                             make_kimera_fixture_bag)
    from fl_slam_tpu_torch.io.rosbag import load_calibration
    from fl_slam_tpu_torch.pipeline import init_state, replay

    t_phase = time.perf_counter()
    cfg = GCConfig.tpu()
    want = _bag_launches(cfg, N_CAM_BAG)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cam_bag_")
    try:
        t0 = time.perf_counter()
        bag_dir, gt = make_kimera_fixture_bag(
            os.path.join(tmp, "bag"), n_scans=N_CAM_BAG, seed=0,
            n_az=BAG_N_AZ, camera=True)
        bag_s = time.perf_counter() - t0
        calib_path = os.path.join(bag_dir, "fixture_calibration.json")
        calib = load_calibration(calib_path)
        cam = dict(cam_topics=KIMERA_CAM_TOPICS,
                   intrinsics=calib["intrinsics"],
                   T_base_cam=calib["T_base_cam"])

        def run(tag):
            return _counted_run_eval([
                "--out", os.path.join(tmp, tag), "--bag", bag_dir,
                "--profile", "kimera", "--calib", calib_path, "--gt", gt,
                "--scans", str(N_CAM_BAG), "--seg-len", str(CAM_BAG_SEG),
                "--stream"])

        live = run("live")
        whole, mono, replay_s, init = _whole_bag_replay(
            bag_dir, cfg, N_CAM_BAG, cam)
        valid = whole.cam_valid.sum(dim=1).cpu().numpy()
        # the operands of scan 20, the second chunk's last (the first
        # chunk's view is empty)
        ops = _capture(lambda: replay(init_state(cfg, **init),
                                      _slice(whole, N_RERUN), cfg))
        ops["camera_rows"] = int(valid[N_RERUN - 1])
        held = _camera_checks(ops, cfg.n_feat)
        held.update(_belief_held(ops, "camera-on bag scan"))
        del whole, ops
        t0 = time.perf_counter()
        sidecar = build_sidecar(bag_dir, KIMERA_CAM_TOPICS,
                                calib["intrinsics"], cfg.n_feat)
        sidecar_s = time.perf_counter() - t0
        cached = run("sidecar")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs = {}
    for tag, (res, counts, seg_syncs, loop_syncs) in (("live", live),
                                                       ("sidecar", cached)):
        runs[tag] = _bag_result(f"camera bag path ({tag})", res, counts,
                                seg_syncs, loop_syncs, N_CAM_BAG,
                                CAM_BAG_SEG, want)
        audit = res["audit"]
        index = res["stager"].cam_index
        runs[tag].update(camera_scans=audit["camera_scans"],
                         camera_pairs=audit["camera_pairs"],
                         feature_cache=audit.get("camera_feature_cache"),
                         held_payload_bytes=sum(
                             len(m.data) for m in index.rgb_msgs
                             + index.depth_msgs))
    gap = np.abs(live[0]["poses"] - cached[0]["poses"]).max(axis=0)
    result = dict(
        config="GCConfig.tpu()", scans=N_CAM_BAG, seg_len=CAM_BAG_SEG,
        camera_frame=[calib["intrinsics"].width,
                      calib["intrinsics"].height],
        bag_build_s=bag_s, sidecar_build_s=sidecar_s,
        valid_camera_rows_per_scan={"min": int(valid.min()),
                                    "mean": float(valid.mean()),
                                    "of": cfg.n_feat},
        live=runs["live"], sidecar=runs["sidecar"],
        live_vs_sidecar_max_pose_gap=gap.tolist(),
        replay_only_scans_per_s=N_CAM_BAG / replay_s,
        streamed_equals_monolithic=bool(np.array_equal(live[0]["poses"],
                                                       mono)),
        kernels_on_bag_operands=held,
        launches_per_scan={k: v / N_CAM_BAG
                           for k, v in runs["live"]["launches"].items()},
        camera_off_staging_included_scans_per_s=bag_off[
            "staging_included_scans_per_s"],
        camera_off_staging_ms_per_scan=bag_off["staging_ms_per_scan"],
        phase_s=time.perf_counter() - t_phase)
    print("camera bag: " + json.dumps(result), flush=True)
    print(f"camera bag: staging {runs['live']['staging_ms_per_scan']:.1f} "
          f"ms a scan live, {runs['sidecar']['staging_ms_per_scan']:.1f} "
          f"with the sidecar (camera off "
          f"{bag_off['staging_ms_per_scan']:.1f}); staging included "
          f"{runs['live']['staging_included_scans_per_s']:.2f} / "
          f"{runs['sidecar']['staging_included_scans_per_s']:.2f} scans/s "
          f"(camera off {bag_off['staging_included_scans_per_s']:.2f}); "
          f"valid camera rows a scan min {int(valid.min())} mean "
          f"{valid.mean():.1f}; ATE live {runs['live']['ate_trans_m']:.4f} "
          f"m / {runs['live']['ate_rot_deg']:.3f} deg, sidecar "
          f"{runs['sidecar']['ate_trans_m']:.4f} m / "
          f"{runs['sidecar']['ate_rot_deg']:.3f} deg; pose gap live vs "
          f"sidecar {gap.max():.3g}; camera payloads held "
          f"{runs['live']['held_payload_bytes'] / N_CAM_BAG / 1e3:.1f} kB a "
          f"scan; phase {result['phase_s']:.1f} s", flush=True)
    for tag, r in runs.items():
        if r["camera_scans"] != N_CAM_BAG:
            raise AssertionError(f"camera bag path ({tag}): camera rows in "
                                 f"{r['camera_scans']} of {N_CAM_BAG} scans")
    if runs["sidecar"]["feature_cache"] != sidecar or \
            runs["live"]["feature_cache"] is not None:
        raise AssertionError(f"camera bag path: feature cache "
                             f"{runs['live']['feature_cache']} / "
                             f"{runs['sidecar']['feature_cache']}")
    if not valid.min() > 0:
        raise AssertionError(f"camera bag path: a scan with no valid camera "
                             f"row (min {valid.min()})")
    if not result["streamed_equals_monolithic"]:
        raise AssertionError("camera bag path: the streamed poses differ "
                             "from one replay of the same staged scans")
    return result


def camera_path() -> dict:
    """Phase 10: the camera path on synthetic RGB-D (320 x 240 frames,
    native features fused with the lidar depth into the first n_feat rows
    of every scan's measurement batch). (a) The reference's production
    claim: ``GCConfig.tpu()`` over N_CAMERA drifting-odometry scans, camera
    off and on, counted and sync-checked, with the valid camera rows per
    scan, the host staging ms a frame and a 20-scan camera-on rerun bit for
    bit. (b) The corridor, camera off and on, at the reference test's
    setting (gated) and at ``GCConfig.tpu()`` (printed). (c) The batched
    replay camera on, B = N_INST x N_CAMERA_BATCHED scans, instance 0
    against the single-instance replay. Returns the launch counts of (a)'s
    camera-on run."""
    import numpy as np
    import torch
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.pipeline import init_state, replay

    t_phase = time.perf_counter()
    drift = dict(odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)

    def want(cfg, T):
        return {"predict_evidence": T if cfg.belief_kernel else 0,
                "scalar_tail": T if cfg.belief_kernel else 0,
                "sinkhorn_piT": T, "moment_segment_sum[surfels]": T,
                "moment_segment_sum[fuse]": T,
                "conditional_slab_exchange_ff": T // cfg.view_refresh_every}

    def staged(cfg, n, seed, camera, **kw):
        t0 = time.perf_counter()
        ds = simulate(cfg, n_scans=n, seed=seed, with_camera=camera, **kw)
        return ds, to_scan_inputs(ds, cfg), time.perf_counter() - t0

    # (a) The production claim: the gated runs camera off then on, then
    # one more replay of each in the other order for the wall clock (it
    # moves between runs; compare in turns).
    cfg = GCConfig.tpu()
    claim, stage_s, inputs, turn_ms = {}, {}, {}, {}
    for cam in (False, True):
        ds, inputs[cam], stage_s[cam] = staged(cfg, N_CAMERA, CAMERA_SEED,
                                               cam, **drift)
        claim[cam] = run_replay(cfg, f"GCConfig.tpu() camera "
                                f"{'on' if cam else 'off'}",
                                want(cfg, N_CAMERA), ds, inputs[cam])
    valid = ds.scans["cam_valid"].sum(axis=1)
    on, off = claim[True], claim[False]

    def fresh():
        return init_state(cfg, anchor0=ds.gt_poses[0],
                          t0=float(ds.gt_stamps[0]) - 0.1)

    for cam in (True, False):
        state = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay(state, inputs[cam], cfg)
        torch.cuda.synchronize()
        turn_ms[cam] = (time.perf_counter() - t0) / N_CAMERA * 1e3
    p1 = replay(fresh(), _slice(inputs[True], N_RERUN), cfg)[1].pose
    p2 = replay(fresh(), _slice(inputs[True], N_RERUN), cfg)[1].pose
    rerun = bool(torch.equal(p1, p2))
    del inputs

    # (b) The corridor.
    corridor = {}
    for name, c in (("reference setting", GCConfig.small(**CORRIDOR_CFG)),
                    ("GCConfig.tpu()", cfg)):
        for cam in (False, True):
            ds_c, sc, _ = staged(c, N_CORRIDOR, CORRIDOR_SEED, cam,
                                 world="corridor",
                                 odom_drift_vel_scale=CORRIDOR_DRIFT)
            corridor[name, cam] = run_replay(
                c, f"corridor, {name}, camera {'on' if cam else 'off'}",
                want(c, N_CORRIDOR), ds_c, sc, beat_odom=False)

    # (c) Batched, camera on.
    t0 = time.perf_counter()
    dss = [simulate(cfg, n_scans=N_CAMERA_BATCHED, seed=SEED + i,
                    with_camera=True, **drift) for i in range(N_INST)]
    batched_stage_s = time.perf_counter() - t0
    b = _batched_run(cfg, dss, "camera-on batched replay")

    per_scan = {k: on["launches"][k] / N_CAMERA for k in want(cfg, 1)}
    ref = corridor["reference setting", False], corridor[
        "reference setting", True]
    result = dict(
        config="GCConfig.tpu()", scans=N_CAMERA, seed=CAMERA_SEED,
        camera_frame=[320, 240],
        valid_camera_rows_per_scan={"min": int(valid.min()),
                                    "mean": float(valid.mean()),
                                    "of": cfg.n_feat},
        host_staging_ms_per_frame=(stage_s[True] - stage_s[False])
        / N_CAMERA * 1e3,
        staging_s={"camera_on": stage_s[True], "camera_off": stage_s[False]},
        ms_per_scan_in_turns={
            "order": "off, on, on, off",
            "camera_on": [on["ms_per_scan"], turn_ms[True]],
            "camera_off": [off["ms_per_scan"], turn_ms[False]]},
        ate_camera_on=[on["ate_trans_m"], on["ate_rot_deg"]],
        ate_camera_off=[off["ate_trans_m"], off["ate_rot_deg"]],
        odom_ate=[on["odom_ate_trans_m"], on["odom_ate_rot_deg"]],
        launches_per_scan=per_scan,
        host_syncs_in_replay=on["host_syncs_in_replay"],
        rerun_scans=N_RERUN, rerun_identical=rerun,
        corridor={f"{name}, camera {'on' if cam else 'off'}": dict(
            ate_trans_m=r["ate_trans_m"], ate_rot_deg=r["ate_rot_deg"],
            ate_trans_axis_m=r["ate_trans_axis_m"],
            odom_ate_trans_m=r["odom_ate_trans_m"],
            ms_per_scan=r["ms_per_scan"])
            for (name, cam), r in corridor.items()},
        batched=dict(instances=N_INST, scans=N_CAMERA_BATCHED,
                     simulate_s=batched_stage_s,
                     ms_per_batched_scan=b["t_run"] / N_CAMERA_BATCHED * 1e3,
                     launches={k: v for k, v in b["counts"].items() if v},
                     host_syncs_in_replay=b["syncs"],
                     instance0_vs_single_max_pose_diff=b["diff0"]),
        phase_s=time.perf_counter() - t_phase)
    print("camera: " + json.dumps(result), flush=True)
    print(f"camera: valid rows per scan min {int(valid.min())} mean "
          f"{valid.mean():.1f} of {cfg.n_feat}; host "
          f"staging {result['host_staging_ms_per_frame']:.1f} ms a frame; "
          f"ms/scan in turns off {off['ms_per_scan']:.1f}, on "
          f"{on['ms_per_scan']:.1f}, on {turn_ms[True]:.1f}, off "
          f"{turn_ms[False]:.1f}; ATE on {on['ate_trans_m']:.4f} m / "
          f"{on['ate_rot_deg']:.3f} deg, off {off['ate_trans_m']:.4f} m / "
          f"{off['ate_rot_deg']:.3f} deg; corridor (reference setting) on "
          f"{ref[1]['ate_trans_m']:.4f} m, off {ref[0]['ate_trans_m']:.4f} "
          f"m; phase {result['phase_s']:.1f} s", flush=True)
    for key, limit in CAMERA_CLAIM.items():
        if not on[key] < limit:
            raise AssertionError(f"camera path: camera-on {key} {on[key]} "
                                 f"is not below {limit}")
    if not on["ate_trans_m"] < 1.5 * off["ate_trans_m"] + 0.02:
        raise AssertionError(f"camera path: camera on {on['ate_trans_m']} "
                             f"m against off {off['ate_trans_m']} m")
    if not (valid.min() > 0 and rerun):
        raise AssertionError(f"camera path: valid rows min {valid.min()}, "
                             f"rerun identical {rerun}")
    if not ref[1]["ate_trans_m"] < 0.8 * ref[0]["ate_trans_m"]:
        raise AssertionError(f"camera path: corridor camera on "
                             f"{ref[1]['ate_trans_m']} m not below 0.8 x "
                             f"off {ref[0]['ate_trans_m']} m")
    return on["launches"]


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

    from fl_slam_tpu_torch.config import GCConfig
    cam_ops = _captured_operands(GCConfig.tpu(), camera=True)
    rows = (check_kernels(cam_ops) + check_belief_kernels(cam_ops)
            + check_batched_kernels() + check_render_select_kernels())
    del cam_ops
    _print_belief_times(rows)
    _print_redesign_times(rows)
    main_run, ds, scans = main_path()
    bcounts = batched_path()
    scounts = select_path(main_run, ds, scans)
    del ds, scans
    rcounts = render_path()
    bag_off = bag_path()
    camera_path()
    camera_bag_path(bag_off)
    for row in rows:
        key = row.pop("launch_key")
        # One-instance kernels count in the GCConfig.tpu() replay of phase
        # 4; the batched ones (and K6, K10) in the batched replay of phase
        # 6; K9 in the select_kernel replay of phase 7; K8 in the render of
        # phase 8.
        row["launches"] = (main_run["launches"][key] if key in _SINGLE_PATH
                           else scounts[key] if key in _SELECT_PATH
                           else rcounts[key] if key in _RENDER_PATH
                           else bcounts[key])
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
