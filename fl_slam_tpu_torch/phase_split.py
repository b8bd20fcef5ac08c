"""Where K1 (predict_evidence) and K2 (scalar_tail) spend their time, on one
CUDA device.

  python3 -m fl_slam_tpu_torch.phase_split [--out FILE]

Builds copies of the two kernels with a ``%globaltimer`` / ``clock64`` stamp
before each anchor line (lane 0 of each of the first 8 warps of block 0
records its own time), runs them on the operands K1 and K2 receive on the
last scan of a 10-scan ``GCConfig.tpu()`` replay, and prints one JSON
object: per kernel the ``ptxas -v`` lines (registers, stack, spills), the
SASS instruction count of each instantiation, the device us per call of the
unstamped kernel (torch.profiler) back to back, after a 256 MB memset (cold
L2), after a sort (other kernels in between, as in the replay) and at
B = 8, and the stamps (us after stamp 0, per warp) back to back, after a
sort and inside a 30-scan replay. The stamped copies are scratch builds; the shipped kernels carry no stamp.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import tempfile
from pathlib import Path

from fl_slam_tpu_torch import cuda_build

# Stamp anchors: (regex, label), each found in order from the kernel's
# __global__ line; the stamp goes before the matching line.
CURRENT = {
    "predict_evidence": [
        (r"// ---- phase 1: the predict mean", "start"),
        (r"^  \} else \{$", "w0: mean done"),
        (r"^  __syncthreads\(\);$", "phase 1 done"),
        (r"// ---- phase 2", "after barrier 1"),
        (r"^    __syncwarp\(\);$", "w0: chol22 done"),
        (r"^    __syncwarp\(\);$", "w0: 22-rhs solve done"),
        (r"^  \} else \{$", "w0: L_pred, h_pred done"),
        (r"^    if \(warp == wOdom\) \{$", "w1-7: pose predicted"),
        (r"^      __syncwarp\(\);$", "w1: chol6 done"),
        (r"^      odom_pose_factor", "w1: 6 solves done"),
        (r"^    \} else if \(lane == 0\) \{$", "w1: pose factor done"),
        (r"^  __syncthreads\(\);$", "phase 2 done"),
        (r"// ---- phase 3", "after barrier 2"),
        (r"^    __syncwarp\(\);$", "w0: W row, h_io done"),
        (r"warp_solve1<T, N>\(sL", "w0: chol22 #2 done"),
        (r"if \(lane < N\) out\[oZlin", "w0: solve1 done"),
        (r"^  \} else \{$", "w0: pose done"),
        (r"^}$", "end")],
    "scalar_tail": [
        (r"// ---- phase 1 ---", "start"),
        (r"^  \} else if \(warp == 1\)", "w0: temper done"),
        (r"^  \} else \{$", "w1: iw_meas done"),
        (r"^  __syncthreads\(\);$", "phase 1 done"),
        (r"// ---- phase 2", "after barrier 1"),
        (r"^    warp_chol<T, N>\(sW, sL", "w0: W row done"),
        (r"^    if \(lane < kRhs\)", "w0: chol22 done"),
        (r"^    __syncwarp\(\);$", "w0: 23-rhs solve done"),
        (r"else if \(warp == wBar\)", "w0: Sigma done"),
        (r"^    warp_chol<T, N>\(sW2", "w1: rows done"),
        (r"^    if \(lane == 0\) \{$", "w1: chol22 #2 done"),
        (r"else if \(warp == wSide\)", "w1: traces done"),
        (r"warp_solve1<T, 6>", "w2: chol6 done"),
        (r"^  __syncthreads\(\);$", "phase 2 done"),
        (r"// ---- phase 3", "after barrier 2"),
        (r"^      if \(warp == wDense\) \{$", "w0, w3: drift numbers done"),
        (r"^    __syncwarp\(\);$", "w0: z_drift / w3: anchors done"),
        (r"^      bar_sync\(2, 96\);$", "w0: mu_next done"),
        (r"^    \} else \{$", "w0: next pose done"),
        (r"^  \} else if \(warp == wBar\) \{$", "w3: anchor effect done"),
        (r"^    bar_sync\(1, 64\);$", "w1: at the z_drift wait"),
        (r"warp_solve1<T, N>\(sL2", "w1: h_fin done"),
        (r"^    T mb6\[6\];$", "w1: solve1 done"),
        (r"^  \} else if \(warp == wSide\) \{$", "w1: published pose done"),
        (r"^}$", "end")],
}

_STAMP = r'''
#ifndef STAMP_BLOCK
#define STAMP_BLOCK 0
#endif
__device__ unsigned long long g_stamp[2][64 * 8];
__device__ __forceinline__ void stamp_(int i) {
  if (threadIdx.x % 32 == 0 && threadIdx.x < 256
      && blockIdx.x == STAMP_BLOCK) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamp[0][i * 8 + threadIdx.x / 32] = t;
    g_stamp[1][i * 8 + threadIdx.x / 32] = clock64();
  }
}
extern "C" int read_stamps(unsigned long long* h) {
  static unsigned long long zero[2][64 * 8];
  int rc = (int)cudaMemcpyFromSymbol(h, g_stamp, sizeof(g_stamp));
  return rc ? rc : (int)cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));
}
'''
_KERNELS = {"predict_evidence": (0, "pe_kernel"),
            "scalar_tail": (1, "tail_kernel")}


def stamp_lines(source: str, anchors) -> list:
    """Line numbers (1-based) before which the stamps go."""
    lines = source.split("\n")
    pos = next(i for i, l in enumerate(lines) if "__global__" in l)
    out = []
    for pat, label in anchors:
        k = next((i for i in range(pos, len(lines))
                  if re.search(pat, lines[i])), None)
        if k is None:
            raise ValueError(f"anchor {label!r} ({pat}) not found")
        out.append(k + 1)
        pos = k + 1
    return out


def stamped_source(source: str, lines,
                   include: str = '#include "belief_common.cuh"') -> str:
    """``source`` with ``stamp_(i)`` before line ``lines[i]`` and the stamp
    code after ``include`` (block STAMP_BLOCK, default 0, records)."""
    text = source.split("\n")
    for i, ln in sorted(enumerate(lines), key=lambda p: -p[1]):
        text.insert(ln - 1, f"stamp_({i});")
    return "\n".join(text).replace(include, include + "\n" + _STAMP, 1)


def _nvcc(src: Path, name: str, cu: Path, so: Path, extra=()) -> str:
    cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS,
           *cuda_build.EXTRA_FLAGS.get(name, ()), *extra, "-I", str(src),
           "-o", str(so), str(cu)]
    r = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {cu}:\n{r.stdout}{r.stderr}")
    return r.stdout + r.stderr


def _sass_counts(so: Path) -> dict:
    sass = subprocess.run([str(Path(cuda_build.nvcc()).with_name(
        "cuobjdump")), "-sass", str(so)], capture_output=True, text=True,
        check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = "f64" if "IdEEv" in line else "f32"
            counts[cur] = 0
        elif cur and line.strip().startswith("/*") and "*/" in line[:20]:
            counts[cur] += 1
    return counts


def _eager_replay(state, scans, cfg):
    """``pipeline.replay`` with its phases run eagerly, so that hooks on
    the kernel wrappers see every call (a CUDA graph replay calls none)."""
    from fl_slam_tpu_torch import graphs
    from fl_slam_tpu_torch.pipeline import replay
    reason = graphs.eager_reason
    graphs.eager_reason = lambda dev: "hooked"
    try:
        return replay(state, scans, cfg)
    finally:
        graphs.eager_reason = reason


def _captured_operands(cfg):
    """The operands K1 and K2 receive on the last scan of a 10-scan replay
    (seed 4), copied on the way in."""
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.ops import belief_kernels as bk
    from fl_slam_tpu_torch.pipeline import init_state

    seen = {}
    fns = (bk.predict_evidence_packed, bk.scalar_tail_packed)

    def hook(k, fn):
        def h(c, *ops):
            seen[k] = [t.clone() for t in ops]
            return fn(c, *ops)
        return h
    ds = simulate(cfg, n_scans=10, seed=4, odom_drift_vel_scale=1.03,
                  odom_drift_yaw_rate=0.01)
    bk.predict_evidence_packed, bk.scalar_tail_packed = (
        hook(0, fns[0]), hook(1, fns[1]))
    try:
        _eager_replay(init_state(cfg, anchor0=ds.gt_poses[0],
                                 t0=float(ds.gt_stamps[0]) - 0.1),
                      to_scan_inputs(ds, cfg), cfg)
    finally:
        bk.predict_evidence_packed, bk.scalar_tail_packed = fns
    return seen[0], seen[1]


def _device_us(fn, sym: str, before=None, reps: int = 20) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if f"::{sym}<" in e.key]
    return (sum(e.self_device_time_total for e in hits)
            / max(sum(e.count for e in hits), 1))


def _read(lib, n: int):
    """(us, cycles) after stamp 0 of warp 0, per stamp and warp; None
    where a warp did not pass the stamp."""
    import torch
    h = (ctypes.c_ulonglong * 1024)()
    torch.cuda.synchronize()
    cuda_build.check(lib, lib.read_stamps(h), "read_stamps")
    t0, c0 = h[0], h[512]
    return [[((h[i * 8 + w] - t0) / 1e3, h[512 + i * 8 + w] - c0)
             if h[i * 8 + w] else None for w in range(8)] for i in range(n)]


def _median(runs, labels) -> dict:
    out = {}
    for i, label in enumerate(labels):
        row = {}
        for w in range(8):
            vals = [r[i][w] for r in runs if r[i][w] is not None]
            if vals:
                row[f"w{w}"] = round(statistics.median(v[0] for v in vals),
                                     3)
        out[label] = row
    return out


def main() -> int:
    import torch

    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.ops import belief_kernels as bk
    from fl_slam_tpu_torch.runtime import configure_numerics

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_split: no CUDA device")
    configure_numerics()
    src = cuda_build.CSRC
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = GCConfig.tpu()
    dev = torch.device("cuda")
    ops = _captured_operands(cfg)
    big = torch.empty(64 * 2 ** 20, device=dev)
    keys = torch.randn(1 << 20, device=dev)
    flush, sort = big.zero_, lambda: torch.sort(keys)
    fns = {"predict_evidence": bk.predict_evidence_packed,
           "scalar_tail": bk.scalar_tail_packed}
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=cuda_build.BUILD_DIR))
    res = {"card": card}
    libs, lines = {}, {}
    for name, (k, sym) in _KERNELS.items():
        source = (src / f"{name}.cu").read_text()
        so = work / f"{name}.so"
        log = _nvcc(src, name, src / f"{name}.cu", so,
                    ("-Xptxas", "-v"))
        r = {"ptxas": [l.strip() for l in log.splitlines()
                       if "Used" in l or "stack frame" in l],
             "sass_instructions": _sass_counts(so)}
        cuda_build._LIBS[name] = cuda_build.bind(ctypes.CDLL(str(so)), name)
        fn = fns[name]
        for dt in (torch.float32, torch.float64):
            x = [t.to(dev, dt) for t in ops[k]]
            d = str(dt).removeprefix("torch.")
            call = lambda: fn(cfg, *x)  # noqa: E731
            r[f"device_us_{d}"] = {
                "back_to_back": _device_us(call, sym),
                "after_l2_memset": _device_us(call, sym, flush),
                "after_sort": _device_us(call, sym, sort)}
        xb = [torch.stack([t.to(dev, torch.float32)] * 8) for t in ops[k]]
        r["device_us_float32"]["batched_8"] = _device_us(
            lambda: torch.func.vmap(lambda *a: fn(cfg, *a))(*xb), sym)
        lines[name] = stamp_lines(source, CURRENT[name])
        cu = work / f"{name}_stamped.cu"
        cu.write_text(stamped_source(source, lines[name]))
        _nvcc(src, name, cu, work / f"{name}_stamped.so")
        lib = cuda_build.bind(ctypes.CDLL(str(work / f"{name}_stamped.so")),
                              name)
        libs[name] = lib
        cuda_build._LIBS[name] = lib
        labels = [label for _, label in CURRENT[name]]
        x = [t.to(dev, torch.float32) for t in ops[k]]
        for setting, before in (("back_to_back", None), ("after_sort", sort)):
            runs = []
            for _ in range(15):
                if before is not None:
                    before()
                fn(cfg, *x)
                runs.append(_read(lib, len(labels)))
            r[f"stamps_us_{setting}"] = _median(runs, labels)
        res[name] = r
    # Inside a replay: the stamps of every call after the first 10 scans.
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.pipeline import init_state
    runs = {name: [] for name in _KERNELS}

    def hook(name):
        def h(c, *a):
            out = fns[name](c, *a)
            runs[name].append(_read(libs[name], len(lines[name])))
            return out
        return h
    ds = simulate(cfg, n_scans=30, seed=3, odom_drift_vel_scale=1.03,
                  odom_drift_yaw_rate=0.01)
    bk.predict_evidence_packed = hook("predict_evidence")
    bk.scalar_tail_packed = hook("scalar_tail")
    try:
        _eager_replay(init_state(cfg, anchor0=ds.gt_poses[0],
                                 t0=float(ds.gt_stamps[0]) - 0.1),
                      to_scan_inputs(ds, cfg), cfg)
    finally:
        bk.predict_evidence_packed = fns["predict_evidence"]
        bk.scalar_tail_packed = fns["scalar_tail"]
    for name in _KERNELS:
        res[name]["stamps_us_in_replay"] = _median(
            runs[name][10:], [label for _, label in CURRENT[name]])
    text = json.dumps(res, indent=1)
    if args.out is not None:
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
