"""Where K6's host time and K9's device time go, on one CUDA device.

  python3 -m fl_slam_tpu_torch.launch_split [--k9-sweep] [--out FILE]

K6 (the page gather and write-back of the dense-page insert) at the
batched replay's shape (B = 8 instances of the (32, 7 x 1024) slabs, 7
pages of 128 columns): the wrapper's host time per call under
``torch.func.vmap``, and the same call's steps each timed alone on the
host clock (``time.perf_counter_ns`` over 2,000 calls, median of 5): an
empty ``custom_op`` with an empty vmap rule under the same ``vmap`` (the
floor no kernel design can cut) beside a ``vmap`` of the identity,
``instance_first`` and ``.contiguous()``, ``torch.empty``, the operand
checks, an int64 -> int32 cast of the offsets (what a wrapper that casts
them pays), a ctypes ``argtypes`` assignment (what a wrapper that sets
them per call pays), the current-device query, the raw stream handle, and
``cuda_build.launch`` of the entry point (with the arguments the wrapper
passes); beside them ``torch.gather`` and ``scatter_`` under the same
``vmap``, and the device us per call of the kernel (torch.profiler) at
B = 1 and B = 8. It also prints the ``ptxas -v`` lines of ``select.cu``
and ``page_io.cu``.

``--k9-sweep`` times K9 at N = 1536, V = 5376, f32, one instance and
B = 8, each of its two kernels apart (device us per call): the shipped
kernel at k = 8 and k = 1, and scratch builds of ``select.cu`` (nothing of
them ships) at 1 and 4 rows per lane (2 ships; 1 also in f64), built with
fused multiply-adds, with 9 of the 16 terms, and with the scores but
without the top 2; the shipped code and the rows-per-lane builds are
checked against the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

from fl_slam_tpu_torch import cuda_build

B, CF, S, M, P = 8, 32, 7, 1024, 128
N9, V9, K9 = 1536, 5376, 8


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _host_us(fn, n: int = 2000, reps: int = 5) -> float:
    """Median over ``reps`` of the host time per call of ``fn`` (a sync
    after each batch of ``n`` calls, outside the clock)."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        out.append((time.perf_counter_ns() - t0) / n / 1e3)
        torch.cuda.synchronize()
    return statistics.median(out)


def _device_us(fn, sym: str, reps: int = 50) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if f"::{sym}<" in e.key]
    return (sum(e.self_device_time_total for e in hits)
            / max(sum(e.count for e in hits), 1))


def _ptxas(src: Path, name: str, cu: Path, so: Path, flags=None) -> list:
    flags = cuda_build.EXTRA_FLAGS.get(name, ()) if flags is None else flags
    cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
           "-I", str(src), "-o", str(so), str(cu)]
    r = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {cu}:\n{r.stdout}{r.stderr}")
    return [l.strip() for l in (r.stdout + r.stderr).splitlines()
            if "Used" in l or "spill" in l or "Compiling entry" in l]


def _empty_op():
    import torch

    @torch.library.custom_op("fl_slam_split::empty", mutates_args=(),
                             schema="(Tensor x) -> ()")
    def empty(x):
        return None

    @torch.library.register_vmap("fl_slam_split::empty")
    def empty_vmap(info, in_dims, x):
        return None, None

    return empty


def k6_split() -> dict:
    import torch

    from fl_slam_tpu_torch.runtime import instance_first
    from fl_slam_tpu_torch.structures import atlas_kernels as ak

    vmap = torch.func.vmap
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(3)
    ff = torch.randn((B, CF, S * M), generator=g, device=dev)
    offs = (torch.arange(S, device=dev) * M
            + torch.randint(0, M // P, (B, S), generator=g, device=dev) * P)
    upd = torch.randn((B, CF, S * P), generator=g, device=dev)
    cols = (offs[:, :, None] + torch.arange(P, device=dev)).reshape(B, 1, -1)
    cols = cols.expand(B, CF, S * P)
    page = torch.empty((B, CF, S * P), device=dev)
    empty = _empty_op()
    lib = cuda_build.library("page_io")
    fn = lib.page_gather_f32
    args = ak.page_launch_args("page_gather_ff", ff, offs, page, P)
    argtypes, restype = fn.argtypes, fn.restype

    def checks():
        if ff.device.type != "cuda":
            raise ValueError
        b_, cf_, sm_ = ff.shape
        s_ = offs.shape[1]
        if (tuple(offs.shape) != (b_, s_)
                or tuple(page.shape) != (b_, cf_, s_ * P)
                or page.dtype != ff.dtype or page.device != ff.device):
            raise ValueError
        if ff.dtype not in (torch.float32, torch.float64):
            raise ValueError
        if not (ff.is_contiguous() and page.is_contiguous()):
            raise ValueError

    def assign():
        fn.argtypes = argtypes
        fn.restype = restype

    steps = {
        "vmap_of_identity": lambda: vmap(lambda x: x)(ff),
        "empty_custom_op_under_vmap": lambda: vmap(
            lambda x: (empty(x), x)[1])(ff),
        "empty_custom_op": lambda: empty(ff[0]),
        "instance_first_contiguous":
            lambda: instance_first(B, ff, 0).contiguous(),
        "torch_empty": lambda: torch.empty((B, CF, S * P), device=dev),
        "checks": checks,
        "offs_int32_cast": lambda: offs.to(torch.int32).contiguous(),
        "argtypes_assignment": assign,
        "current_device": torch.cuda.current_device,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "launch_of_the_entry_point": lambda: cuda_build.launch(
            lib, fn, "page_gather_ff", dev, *args),
    }
    res = {"shape": f"ff ({B}, {CF}, {S * M}) f32, {S} pages of {P}",
           "host_us": {k: _host_us(f) for k, f in steps.items()}}
    ffw = ff.clone()

    def gather():
        return vmap(lambda f, o: ak.page_gather_ff(f, o, P))(ff, offs)

    def wb():
        return vmap(lambda f, o, x: ak.page_writeback_ff(f, o, x, P))(
            ffw, offs, upd)

    ffl = ff.clone()
    res["host_us"].update({
        "gather_call": _host_us(gather, n=500),
        "writeback_call": _host_us(wb, n=500),
        "torch_gather_under_vmap": _host_us(lambda: vmap(
            lambda f, c: torch.gather(f, 1, c))(ff, cols), n=500),
        "scatter_under_vmap": _host_us(lambda: vmap(
            lambda f, c, u: f.scatter_(1, c, u))(ffl, cols, upd), n=500)})
    res["device_us"] = {
        "gather_B8": _device_us(gather, "page_kernel"),
        "writeback_B8": _device_us(wb, "page_kernel"),
        "gather_B1": _device_us(lambda: ak.page_gather_ff(ff[0], offs[0], P),
                                "page_kernel"),
        "writeback_B1": _device_us(lambda: ak.page_writeback_ff(
            ffw[0], offs[0], upd[0], P), "page_kernel")}
    return res


# Scratch builds of the shipped K9, each a list of (old text, new text)
# edits of ``select.cu``, whether it builds with -fmad=false, and its rows
# per lane: 1 and 4 rows a lane; the same code with fused multiply-adds; 9
# of the 16 terms; the scores without the top 2.
_ROWS = "constexpr int kRowsPerLane = 2;"
_TERMS = "for (int j = 1; j < kFeat; ++j) acc = acc + ar[r][j] * bv[j];"
_PUSH = "      const bool c1 = acc < m1[r];"
K9_VARIANTS = {
    "rows_per_lane_1": ([(_ROWS, _ROWS.replace("2", "1"))], True, 1),
    "rows_per_lane_4": ([(_ROWS, _ROWS.replace("2", "4"))], True, 4),
    "fused_multiply_add": ([], False, 2),
    "nine_terms": ([(_TERMS, _TERMS.replace("j < kFeat", "j < 9"))], True,
                   2),
    "scores_without_top2": ([(_PUSH, "      m1[r] = m1[r] + acc;\n"
                              "      continue;\n" + _PUSH)], True, 2),
}


def k9_sweep(work: Path) -> dict:
    """K9 through its C entry point with ``select_plan``'s launch (its
    units re-counted for a scratch build's rows per lane): device us per
    call of each of its two kernels, one instance and B = 8, and (except
    for the variants that change what is computed) equality with the plain
    version."""
    import torch

    from fl_slam_tpu_torch.ops import assoc_kernels as ak

    dev = torch.device("cuda", torch.cuda.current_device())
    C = V9 // 128
    res = {}

    def run(lib, dt, k, a, b, check, rows_per_lane=2):
        fn = lib.select_f32 if dt == torch.float32 else lib.select_f64
        row = {}
        for nb in (1, B):
            plan = ak.select_plan(N9, V9, k, a.element_size(), nb)
            units = -(-N9 // (32 * rows_per_lane)) * C
            sv = torch.empty((nb, N9, 2 * C), device=dev, dtype=dt)
            si = torch.empty((nb, N9, 2 * C), device=dev, dtype=torch.int32)
            vals = torch.empty((nb, N9, k), device=dev, dtype=dt)
            idx = torch.empty((nb, N9, k), device=dev, dtype=torch.int32)

            def call():
                cuda_build.launch(lib, fn, "select", dev, a.data_ptr(),
                                  b.data_ptr(), sv.data_ptr(), si.data_ptr(),
                                  vals.data_ptr(), idx.data_ptr(), nb, N9,
                                  V9, k, units, plan["lanes"],
                                  plan["topk_grid"][0], *plan["smem_bytes"])
            row[f"stage1_us_B{nb}"] = _device_us(call, "select_kernel")
            row[f"stage2_us_B{nb}"] = _device_us(call, "select_topk_kernel")
            if check:
                torch.cuda.synchronize()
                row[f"equal_B{nb}"] = all(
                    torch.equal(vals[i], w[0]) and torch.equal(idx[i], w[1])
                    for i, w in enumerate(ak.select_topk_plain(
                        a[i], b[i], k) for i in range(nb)))
        return row

    ops = {}
    for dt in (torch.float32, torch.float64):
        g = torch.Generator(device=dev).manual_seed(5)
        ops[dt] = (torch.randn((B, N9, 16), generator=g, device=dev,
                               dtype=dt),
                   torch.randn((B, 16, V9), generator=g, device=dev,
                               dtype=dt))
    lib = cuda_build.library("select")
    for dt in ops:
        d = str(dt).removeprefix("torch.")
        res[f"{d} shipped k={K9}"] = run(lib, dt, K9, *ops[dt], True)
    res["float32 shipped k=1"] = run(lib, torch.float32, 1,
                                      *ops[torch.float32], True)
    source = (cuda_build.CSRC / "select.cu").read_text()
    for name, (edits, nofma, rows) in K9_VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"K9 variant {name}: {old!r} not in source")
            text = text.replace(old, new, 1)
        cu = work / f"select_{name}.cu"
        cu.write_text(text)
        so = work / f"select_{name}.so"
        lines = _ptxas(cuda_build.CSRC, "select", cu, so,
                       ("-fmad=false",) if nofma else ())
        lib = cuda_build.bind(ctypes.CDLL(str(so)), "select")
        exact = name.startswith("rows_per_lane")
        res[f"variant {name}"] = {"ptxas": lines, **run(
            lib, torch.float32, K9, *ops[torch.float32], exact, rows)}
        if name == "rows_per_lane_1":
            res[f"variant {name} float64"] = run(
                lib, torch.float64, K9, *ops[torch.float64], True, rows)
    return res


def main() -> int:
    import torch

    from fl_slam_tpu_torch.runtime import configure_numerics

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k9-sweep", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_split: no CUDA device")
    configure_numerics()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=cuda_build.BUILD_DIR))
    res = {"card": _card(), "k6": k6_split()}
    if args.k9_sweep:
        res["k9_sweep"] = k9_sweep(work)
    res["ptxas"] = {n: _ptxas(cuda_build.CSRC, n, cuda_build.CSRC / f"{n}.cu",
                              work / f"{n}.so") for n in ("select", "page_io")}
    text = json.dumps(res, indent=1)
    if args.out is not None:
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
