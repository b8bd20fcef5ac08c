"""g++ builds of the port's host libraries from ``src/``: ``libgcio`` (bag
decoding and lidar staging, ``io.native``) and ``libgcvision`` (camera
features and lidar depth evidence, ``camera.features``).

A library is built at first use into a build directory (by default
``fl_slam_tpu_torch/_build/``, listed in ``.gitignore``) under a name keyed
by the hash of its source and flags, so an edited source rebuilds. The build
writes a temporary file and renames it into place, so several processes or
threads may trigger it at once. A failed build raises with the compiler's
output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "src"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_LIBS: dict = {}
_LOCK = threading.Lock()


def target(name: str, source: Path, flags, build_dir) -> Path:
    """Where ``lib<name>`` built from ``source`` with ``flags`` lives."""
    h = hashlib.sha1(" ".join(flags).encode())
    h.update(Path(source).read_bytes())
    return Path(build_dir) / f"{name}-{h.hexdigest()[:12]}.so"


def build(name: str, source: Path, flags, build_dir, cxx: str) -> Path:
    """Compile ``source`` with ``cxx`` and ``flags`` into ``build_dir``
    unless it is built there; returns the library's path. Raises
    RuntimeError when the compiler fails or is missing."""
    out = target(name, source, flags, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *flags, "-o", str(tmp), str(source)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building lib{name}: {cmd[0]} did not run ({e})") \
            from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building lib{name} failed ({' '.join(cmd)}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str, source: Path, flags, build_dir, cxx: str, bind):
    """The loaded library, built at first use and passed once through
    ``bind`` (which sets its ctypes types and returns it)."""
    path = target(name, source, flags, build_dir)
    lib = _LIBS.get(path)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(path)
            if lib is None:
                lib = bind(ctypes.CDLL(str(build(name, source, flags,
                                                 build_dir, cxx))))
                _LIBS[path] = lib
    return lib
