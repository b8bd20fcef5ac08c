"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, one ``nvcc`` per source, all started together,
into ``_build/`` beside this file (listed in ``.gitignore``); a library is
keyed by the hash of its sources, so an edited source rebuilds. A failed
build raises with the compiler's output.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``. ``library`` sets the ctypes argument
and result types of every entry point (``ENTRY_POINTS``) once, when it
loads a library; no wrapper sets them per call. The wrappers call an entry
point through ``launch``, which passes the current stream's raw handle and
makes the operands' device the current one for the call where it is not
(a launch into a stream of a device that is not current fails), and raises
on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("sinkhorn", "moment", "slab_exchange", "page_io",
           "predict_evidence", "scalar_tail", "splat_composite", "select",
           "pose6_cond", "imu_window")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# The belief kernels round every product, as their plain versions do: K1's
# accel-noise moments (M2 - f m1^T - m1 f^T + sw f f^T) cancel to ~1e-3 of
# their terms, and fused multiply-adds there moved the f32 result 1e-3
# relative away from the plain version (H100, captured operands). K8 and
# K9 build the same way, so that they round as their plain versions'
# separate elementwise products and sums do (K8's binning scores and reach
# tests, every one, bit for bit). K11 builds the same way, so that its
# Jacobi rotations round as the plain chain's separate products and sums,
# and K12 so that its prefix products and window sums do.
EXTRA_FLAGS = {"predict_evidence": ("-fmad=false",),
               "scalar_tail": ("-fmad=false",),
               "splat_composite": ("-fmad=false",),
               "select": ("-fmad=false",),
               "pose6_cond": ("-fmad=false",),
               "imu_window": ("-fmad=false",)}

# Each library's C entry points by the codes of their arguments before the
# stream (p: pointer, i: int, q: 64-bit int, d: double); every entry point
# returns an int (a cudaError_t) and takes the stream last.
ENTRY_POINTS = {
    "sinkhorn": {"sinkhorn_f32": "pppiiiiiiddd", "sinkhorn_f64":
                 "pppiiiiiiddd"},
    "moment": {"moment_f32": "ppppppiiiii", "moment_f64": "ppppppiiiii"},
    "slab_exchange": {"slab_exchange_f32": "pppppppiiiiii",
                      "slab_exchange_f64": "pppppppiiiiii"},
    "page_io": {f"page_{k}_{t}": "piqppiiiii" for k in ("gather",
                                                        "writeback")
                for t in ("f32", "f64")},
    "predict_evidence": {"predict_evidence_f32": "p" * 12 + "i",
                         "predict_evidence_f64": "p" * 12 + "i"},
    "scalar_tail": {"scalar_tail_f32": "p" * 20 + "i",
                    "scalar_tail_f64": "p" * 20 + "i"},
    "splat_composite": {"splat_bin_f32": "pppiiiiii",
                        "splat_composite_f32": "ppiiiii"},
    "select": {"select_f32": "pppppp" + "i" * 9,
               "select_f64": "pppppp" + "i" * 9},
    "pose6_cond": {"pose6_cond_f32": "pqqqppid",
                   "pose6_cond_f64": "pqqqppid"},
    "imu_window": {"imu_window_f32": "pq" * 11 + "piidd",
                   "imu_window_f64": "pq" * 11 + "piidd"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong,
           "d": ctypes.c_double}

_LIBS: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(EXTRA_FLAGS.get(name, ())).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
    """Compile the libraries not yet built, in parallel; returns the wall
    seconds."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-I",
               str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = bind(ctypes.CDLL(str(_target(name))), name)
        _LIBS[name] = lib
    return lib


def bind(lib, name: str):
    """Set the argument and result types of every entry point of library
    ``name`` (and of its ``fl_error_string``) on ``lib``; returns it."""
    lib.fl_error_string.argtypes = [ctypes.c_int]
    lib.fl_error_string.restype = ctypes.c_char_p
    for entry, codes in ENTRY_POINTS[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = [_CTYPES[c] for c in codes] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.fl_error_string(rc).decode()})")


def device_guard(device):
    """A context in which ``device`` is the current CUDA device (a no-op
    for a CPU device)."""
    import contextlib

    import torch
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def launch(lib: ctypes.CDLL, fn, what: str, device, *args) -> None:
    """Call the C entry point ``fn`` of ``lib`` with ``args`` and the
    current stream of ``device``, with ``device`` the current device (the
    guard is entered only where it is not); raises on a non-zero code."""
    import torch
    stream = torch._C._cuda_getCurrentRawStream   # no Stream object built
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream(device.index))
    check(lib, rc, what)
