"""Where the time of the map render (``render.splat_kernels.render_tiled``)
goes, on one CUDA device.

  python3 -m fl_slam_tpu_torch.render_split [--reps N] [--stamps]
      [--export RUN_DIR]

Renders at 960 x 720 with K = 64 (the map viewer's widths) two inputs: the
seeded 16,384-splat scene of ``chip_smoke.py`` phase 3 and the map after
100 scans of ``GCConfig.tpu()`` (phase 8's render: the pool's top 16,384
primitives by weight, valid or not). For each it prints one JSON line:
``render_tiled`` (host ms until it returns, wall ms until the device is
done, device ms and kernel launches from ``torch.profiler``, the device us
of K8's kernels apart from the rest, peak device memory above what was
allocated before the call) and the same figures for ``shaded_splats``
(projection, covariances, shading: the torch front of the render), each
called alone on the same inputs; and stage 2's data-dependent work
(``splat_cases.pair_counts`` of the plain binning's rows). It calls
nothing else of the package, so a copy of this file and of
``render/splat_cases.py`` measures another commit's render in that
commit's tree.

``--export RUN_DIR`` measures instead the map of a run's
``splat_export.npz`` as ``render.view_splat`` renders it (its top 16,384
primitives by weight, tinted by height; the chase camera behind the last
pose and the BEV camera), e.g. of ``eval.run_eval`` on the 1,000-scan
Kimera-layout fixture.

``--stamps`` builds a copy of ``csrc/splat_composite.cu`` with a
``%globaltimer`` / ``clock64`` stamp before each line of ``BIN_ANCHORS``
in ``bin_kernel`` (lane 0 of each warp of the block that bins the image's
middle tile row), runs stage 1 on both inputs and prints where each warp
of that block spends its time (median over 15 calls), beside the device
us per call of the shipped, unstamped stage 1. The stamped copy is a
scratch build; the shipped kernel carries no stamp.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import tempfile
import time
from pathlib import Path

SEED = 3
WIDTH, HEIGHT, K = 960, 720, 64
N_PRIMS = 16384
N_SCANS = 100
# K8's kernels in a profile of the render: stage 1, stage 2.
STAGES = {"pack_kernel": "stage1", "bin_kernel": "stage1",
          "composite_kernel": "stage2"}
# Stamps in bin_kernel: (regex, label), each found in order after the
# previous one; the stamp goes before the matching line.
BIN_ANCHORS = [
    (r"^  for \(int s0 = 0; s0 < N; s0 \+= kListCap\) \{$", "start"),
    (r"^    int n = __popcll\(mask\), incl = n;$", "culled"),
    (r"^    int off = incl - n, total = 0;$", "barrier 1 (count scan)"),
    (r"^    // This warp's share of the listed splats", "listed, barrier 2"),
    (r"^    __syncthreads\(\);  +// before list is rewritten", "scored"),
    (r"^  if \(live && nbuf > 0\) \{$", "barrier 3"),
    (r"^  // The shares' kept keys", "buffer merged"),
    (r"^  if \(part != 0 \|\| !live\) return;$", "shares merged"),
    (r"^  float4\* dst = ", "depth keys"),
    (r"^}$", "rows written"),
]


def _card() -> str:
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _kernel(key: str):
    """K8's kernel in a profiler event key, or None."""
    return next((k for k in STAGES if f"::{k}(" in key or
                 key.startswith(f"{k}(")), None)


def _measure(fn, reps: int) -> dict:
    """Host ms until ``fn`` returns and wall ms until the device is done
    (medians over ``reps`` calls, a sync before each), device ms and
    kernel launches per call (torch.profiler, CUDA activity), K8's
    kernels' device us and launches per call apart, and the peak device
    memory of one call above what was allocated before it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
        del out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    own = {}
    for e in kernels:
        k = _kernel(e.key)
        if k is not None:
            us, n = own.get(STAGES[k], (0.0, 0.0))
            own[STAGES[k]] = (us + e.self_device_time_total / reps,
                              n + e.count / reps)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return dict(host_ms=statistics.median(host),
                wall_ms=statistics.median(wall), device_ms=device_ms,
                launches=sum(e.count for e in kernels) / reps,
                k8={s: {"device_us": us, "launches": n}
                    for s, (us, n) in own.items()},
                other_device_ms=device_ms - sum(
                    us for us, _ in own.values()) / 1e3,
                peak_mb=peak / 2 ** 20)


def split(prims, cam, label: str, reps: int) -> dict:
    import torch
    from fl_slam_tpu_torch.render import splat_kernels as sk
    from fl_slam_tpu_torch.render.splat_cases import pair_counts
    f32 = torch.float32
    pos, Lam, etas, col, w, val = prims
    cam32 = cam._replace(pose_wc=cam.pose_wc.to(f32))
    return dict(
        scene=label, valid=int(val.sum().item()), N=pos.shape[0],
        render_tiled=_measure(lambda: sk.render_tiled(*prims, cam), reps),
        shaded_splats=_measure(lambda: sk.shaded_splats(
            pos.to(f32), Lam.to(f32), etas.to(f32), col.to(f32), w.to(f32),
            val, cam32, 1e-9), reps),
        pairs=pair_counts(*sk.tile_params(*prims, cam)))


def _stamped_library(block: int):
    """A build of ``csrc/splat_composite.cu`` with ``BIN_ANCHORS``' stamps
    in ``bin_kernel`` for block ``block``; (library, labels)."""
    from fl_slam_tpu_torch import cuda_build, phase_split
    src = cuda_build.CSRC / "splat_composite.cu"
    text = src.read_text()
    lines = phase_split.stamp_lines(text, BIN_ANCHORS)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=cuda_build.BUILD_DIR))
    cu = work / "splat_composite_stamped.cu"
    cu.write_text(phase_split.stamped_source(text, lines,
                                             '#include "common.cuh"'))
    so = work / "splat_composite_stamped.so"
    phase_split._nvcc(cuda_build.CSRC, "splat_composite", cu, so,
                      (f"-DSTAMP_BLOCK={block}",))
    lib = cuda_build.bind(ctypes.CDLL(str(so)), "splat_composite")
    return lib, [label for _, label in BIN_ANCHORS]


def stage1_stamps(table, n_ty: int, n_tx: int, k: int, runs: int = 15):
    """Where the warps of the block that bins the middle tile row spend
    stage 1's time: per stamp and warp, the median us and cycles after
    stamp 0 of warp 0; and the device us per call of the shipped
    stage 1 (``pack_kernel`` and ``bin_kernel``, torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fl_slam_tpu_torch import cuda_build, phase_split
    from fl_slam_tpu_torch.render import splat_kernels as sk
    call = lambda: sk.bin_tiles(table, n_ty, n_tx, k)  # noqa: E731
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    shipped = {}
    for e in prof.key_averages():
        kern = _kernel(e.key)
        if kern is not None:
            shipped[kern] = {"device_us": e.self_device_time_total / 20,
                             "launches": e.count / 20}
    block = (n_ty // 2) * n_tx // sk.BIN_TILES_PER_BLOCK
    lib, labels = _stamped_library(block)
    real = cuda_build._LIBS.get("splat_composite")
    cuda_build._LIBS["splat_composite"] = lib
    try:
        call()
        got = []
        for _ in range(runs):
            call()
            got.append(phase_split._read(lib, len(labels)))
    finally:
        cuda_build._LIBS["splat_composite"] = real
    stamps = {}
    for i, label in enumerate(labels):
        row = {}
        for w in range(8):
            vals = [r[i][w] for r in got if r[i][w] is not None]
            if vals:
                row[f"w{w}"] = [statistics.median(v[0] for v in vals),
                                statistics.median(v[1] for v in vals)]
        stamps[label] = row
    return dict(block=block, tile_row=n_ty // 2, shipped=shipped,
                stamps_us_cycles=stamps)


def _phase8_prims():
    """Phase 8's render input: the pool's top 16,384 primitives after
    N_SCANS scans of ``GCConfig.tpu()`` (slabs flushed), and its camera."""
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.pipeline import flush_slabs, init_state, replay
    from fl_slam_tpu_torch.render import splat
    cfg = GCConfig.tpu()
    ds = simulate(cfg, n_scans=N_SCANS, seed=SEED,
                  odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
    st = init_state(cfg, anchor0=ds.gt_poses[0],
                    t0=float(ds.gt_stamps[0]) - 0.1)
    st, _ = replay(st, to_scan_inputs(ds, cfg), cfg)
    prims = splat.atlas_primitives(flush_slabs(st).atlas, cfg, N_PRIMS)
    cam = splat.bev_camera(prims[0][prims[5]].cpu().numpy(), WIDTH, HEIGHT)
    return prims, cam


def _export_scenes(path: str):
    """The export's primitives as ``render.view_splat`` renders them, with
    its chase and BEV cameras: [(prims, camera, label)]."""
    import numpy as np
    import torch
    from fl_slam_tpu_torch.render import splat, view_splat
    pos, Lam, etas, rgb, w, n, d = view_splat.load_primitives(
        view_splat.resolve_npz(path), N_PRIMS)
    dev = torch.device("cuda")
    prims = tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev)
                  for a in (pos, Lam, etas, rgb, w)) + (
        torch.ones((pos.shape[0],), dtype=torch.bool, device=dev),)
    chase = view_splat.chase_camera(d["trajectory"][-1], 2.0, 1.0, WIDTH,
                                    HEIGHT, 70.0)
    return [(prims, chase, f"export_chase_{n}"),
            (prims, splat.bev_camera(pos, WIDTH, HEIGHT), f"export_bev_{n}")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--stamps", action="store_true",
                    help="stage 1's time by step, from a stamped build")
    ap.add_argument("--export", default=None,
                    help="a run directory or splat_export.npz to measure "
                    "instead of the seeded scene and the phase-8 map")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("render_split: needs a CUDA device")
    import fl_slam_tpu_torch
    from fl_slam_tpu_torch.render.splat import bev_camera
    from fl_slam_tpu_torch.render.splat_cases import seeded_scene
    from fl_slam_tpu_torch.runtime import configure_numerics
    configure_numerics()
    card = _card()
    dev = torch.device("cuda")
    if args.export:
        scenes = _export_scenes(args.export)
    else:
        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        scene = seeded_scene(N_PRIMS, g, dev)
        cam = bev_camera(scene[0].cpu().numpy(), WIDTH, HEIGHT)
        scenes = ((scene, cam, "seeded16384"),
                  (*_phase8_prims(), "phase8_map"))
    for prims, c, label in scenes:
        if args.stamps:
            from fl_slam_tpu_torch.render import splat_kernels as sk
            table = sk.splat_table(*prims, c)
            n_ty, n_tx = sk.tile_grid(c)
            out = dict(scene=label, **stage1_stamps(
                table, n_ty, n_tx, sk.tile_budget(table.shape[0], K)))
        else:
            out = split(prims, c, label, args.reps)
        out.update(card=card, package=fl_slam_tpu_torch.__file__)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
