"""ctypes bindings for the C++ batch decoders and the lidar staging kernel
of ``src/gcio.cpp`` (the port's own build of them; port of
``fl_slam_tpu/io/native.py``).

The library is built at first use with g++ (``cxx_build``) into
``BUILD_DIR``; a failed build raises with the compiler's output: nothing
here falls back to the Python decoders. Those run only when a caller asks
for them (``io.rosbag``: ``native_staging=False``).

Every ctypes call releases the interpreter lock, so staging in a worker
thread overlaps the replay in the main thread (``io.rosbag.StreamingStager``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from fl_slam_tpu_torch import cxx_build

SOURCE = cxx_build.SRC_DIR / "gcio.cpp"
BUILD_DIR = cxx_build.BUILD_DIR
CXX = "g++"
# build_native.sh's flags. -fno-math-errno / -fno-trapping-math change no
# value; they let gcc vectorize the staging kernel's sigmoid pass.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-fno-math-errno",
             "-fno-trapping-math")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64 = ctypes.c_int64
_dbl = ctypes.c_double


def build(build_dir=None):
    """Compile ``src/gcio.cpp`` with ``CXX`` into ``build_dir`` (default
    ``BUILD_DIR``) unless its library is built there; returns the library's
    path. Raises RuntimeError when the compiler fails or is missing."""
    return cxx_build.build("gcio", SOURCE, CXX_FLAGS,
                           BUILD_DIR if build_dir is None else build_dir, CXX)


def _bind(lib):
    lib.gcio_decode_imu_batch.restype = _i64
    lib.gcio_decode_imu_batch.argtypes = [_u8p, _i64p, _i64p, _i64, _f64p]
    lib.gcio_decode_odom_batch.restype = _i64
    lib.gcio_decode_odom_batch.argtypes = [_u8p, _i64p, _i64p, _i64, _f64p]
    lib.gcio_decode_pointcloud2.restype = _i64
    lib.gcio_decode_pointcloud2.argtypes = [_u8p, _i64, _f64p, _f32p, _f32p,
                                            _i32p, _i64]
    common = [ctypes.POINTER(_u8p), _i64p, _i64,    # blob pointers, sizes, S
              _f64p, _f64p,                         # R_bl, t_bl
              _dbl, _dbl, _dbl, _dbl,               # radii, sigma, sentinel
              _i64, _i64,                           # n_cap, raw_cap
              _f64p, _i64, _i64, _dbl,              # imu, n, len, accel_scale
              _f64p, _i64, _dbl]                    # odom, n, prev_t
    lib.gcio_stage_lidar_batch.restype = _i64
    lib.gcio_stage_lidar_batch.argtypes = common + [_f64p] * 12 + [_i64p]
    lib.gcio_stage_lidar_batch_f32.restype = _i64
    lib.gcio_stage_lidar_batch_f32.argtypes = common + [
        _dbl, _dbl, _f64p,                          # origin, margin, out
        _f32p, _f32p, _f32p, _f64p, _f64p,          # pts / st / w / ss / se
        _f32p, _f32p, _f32p,                        # imu out
        _f32p, _f32p, _f32p, _f32p,                 # odom out
        _i64p]                                      # audit
    return lib


def library():
    """The built and bound library (built at first use; raises when the
    build fails)."""
    return cxx_build.library("gcio", SOURCE, CXX_FLAGS, BUILD_DIR, CXX, _bind)


def _pack(blobs):
    offsets = np.zeros(len(blobs), dtype=np.int64)
    sizes = np.asarray([len(b) for b in blobs], dtype=np.int64)
    if len(blobs) > 1:
        np.cumsum(sizes[:-1], out=offsets[1:])
    blob = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    return blob, offsets, sizes


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def decode_imu_batch(blobs) -> np.ndarray:
    """CDR Imu buffers -> (N, 7) [stamp, gyro xyz, accel xyz]."""
    lib = library()
    n = len(blobs)
    out = np.zeros((n, 7), dtype=np.float64)
    if n == 0:
        return out
    blob, offsets, sizes = _pack(blobs)
    done = lib.gcio_decode_imu_batch(
        _ptr(blob, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        _ptr(sizes, ctypes.c_int64), n, _ptr(out, ctypes.c_double))
    if done != n:
        raise ValueError(f"native imu decode: {done}/{n} messages ok")
    return out


def decode_odom_batch(blobs) -> np.ndarray:
    """CDR Odometry buffers -> (N, 86)
    [stamp, pos3, quat4, pose_cov36, vel3, omega3, twist_cov36]."""
    lib = library()
    n = len(blobs)
    out = np.zeros((n, 86), dtype=np.float64)
    if n == 0:
        return out
    blob, offsets, sizes = _pack(blobs)
    done = lib.gcio_decode_odom_batch(
        _ptr(blob, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        _ptr(sizes, ctypes.c_int64), n, _ptr(out, ctypes.c_double))
    if done != n:
        raise ValueError(f"native odom decode: {done}/{n} messages ok")
    return out


def decode_pointcloud2(buf: bytes, cap: int):
    """One CDR PointCloud2 -> (stamp, xyz (n, 3) f32, time (n,) f32,
    ring (n,) i32), n <= cap."""
    lib = library()
    buf_np = np.frombuffer(buf, dtype=np.uint8)
    stamp = np.zeros(1, dtype=np.float64)
    xyz = np.zeros((cap, 3), dtype=np.float32)
    t = np.zeros(cap, dtype=np.float32)
    ring = np.zeros(cap, dtype=np.int32)
    n = lib.gcio_decode_pointcloud2(
        _ptr(buf_np, ctypes.c_uint8), len(buf), _ptr(stamp, ctypes.c_double),
        _ptr(xyz, ctypes.c_float), _ptr(t, ctypes.c_float),
        _ptr(ring, ctypes.c_int32), cap)
    if n < 0:
        raise ValueError("native pointcloud2 decode failed")
    return float(stamp[0]), xyz[:n], t[:n], ring[:n]


# Staged fields by the shape after the scan axis; scan_start / scan_end
# are f64 whatever the dtype of the rest (absolute epoch-second stamps).
def stage_shapes(n_cap: int, imu_len: int) -> dict:
    return {
        "points": (n_cap, 3), "point_stamps": (n_cap,),
        "point_weights": (n_cap,), "scan_start": (), "scan_end": (),
        "imu_stamps": (imu_len,), "imu_gyro": (imu_len, 3),
        "imu_accel": (imu_len, 3), "odom_pose": (6,), "odom_cov": (6, 6),
        "odom_vel_body": (3,), "odom_omega_body": (3,),
    }


def alloc_stage_out(S, n_cap, imu_len, dtype=np.float64) -> dict:
    """Zero-filled output arrays of ``S`` scans for the staging kernel."""
    return {k: np.zeros((S,) + shp,
                        np.float64 if k in ("scan_start", "scan_end")
                        else dtype)
            for k, shp in stage_shapes(n_cap, imu_len).items()}


def _check_out(out: dict, S, n_cap, imu_len, dtype) -> None:
    for k, shp in stage_shapes(n_cap, imu_len).items():
        a = out[k]
        want = np.float64 if k in ("scan_start", "scan_end") else dtype
        if (a.shape != (S,) + shp or a.dtype != want
                or not a.flags.c_contiguous or not a.flags.writeable):
            raise ValueError(f"staging output {k}: {a.dtype} {a.shape}, "
                             f"want a writable contiguous {np.dtype(want)} "
                             f"{(S,) + shp}")


def _stage_args(blobs, R_bl, t_bl, min_r, max_r, sigma, sentinel, n_cap,
                raw_cap, imu, imu_len, accel_scale, odom, prev_t):
    S = len(blobs)
    # Borrowed pointers into each bytes object (c_char_p aliases its
    # buffer); ``blobs`` stays alive across the call.
    bufs = (_u8p * S)(*(ctypes.cast(ctypes.c_char_p(b), _u8p)
                        for b in blobs))
    sizes = np.asarray([len(b) for b in blobs], dtype=np.int64)
    keep = [np.ascontiguousarray(a, dtype=np.float64)
            for a in (R_bl, t_bl, imu, odom)]
    if keep[0].shape != (3, 3) or keep[1].shape != (3,):
        raise ValueError("R_bl must be (3, 3) and t_bl (3,)")
    if keep[2].ndim != 2 or keep[2].shape[1:] != (7,) \
            or keep[3].ndim != 2 or keep[3].shape[1:] != (86,):
        raise ValueError("imu must be (M, 7) and odom (N, 86)")
    args = [bufs, _ptr(sizes, ctypes.c_int64), S,
            _ptr(keep[0], ctypes.c_double), _ptr(keep[1], ctypes.c_double),
            float(min_r), float(max_r), float(sigma), float(sentinel),
            int(n_cap), int(raw_cap), _ptr(keep[2], ctypes.c_double),
            keep[2].shape[0], int(imu_len), float(accel_scale),
            _ptr(keep[3], ctypes.c_double), keep[3].shape[0],
            float("nan") if prev_t is None else float(prev_t)]
    return args, (bufs, sizes, keep)


_OUT_ORDER = ("points", "point_stamps", "point_weights", "scan_start",
              "scan_end", "imu_stamps", "imu_gyro", "imu_accel", "odom_pose",
              "odom_cov", "odom_vel_body", "odom_omega_body")


def stage_lidar_batch(blobs, *, R_bl, t_bl, min_r, max_r, sigma, sentinel,
                      n_cap, raw_cap, imu, imu_len, accel_scale, odom,
                      prev_t=None, out=None) -> tuple:
    """Stage a batch of lidar scans in one native call (decode, sentinel,
    range weights, extrinsic, budget resample, IMU windows, closest odom),
    f64 with absolute stamps: the twin of ``io.rosbag._python_stage_blobs``.

    ``imu`` (M, 7) and ``odom`` (N, 86) must be stamp-sorted. ``prev_t``:
    scan_start before this batch (None at the bag's start). ``out``: the
    output arrays (``alloc_stage_out`` of ``len(blobs)`` scans, or views of
    the caller's buffer), written in place. Returns (out, audit counts
    (nonfinite points, saturated IMU windows, missing odometry))."""
    lib = library()
    S = len(blobs)
    out = alloc_stage_out(S, n_cap, imu_len) if out is None else out
    _check_out(out, S, n_cap, imu_len, np.float64)
    args, keep = _stage_args(blobs, R_bl, t_bl, min_r, max_r, sigma,
                             sentinel, n_cap, raw_cap, imu, imu_len,
                             accel_scale, odom, prev_t)
    audit = np.zeros(3, dtype=np.int64)
    rc = lib.gcio_stage_lidar_batch(
        *args, *(_ptr(out[k], ctypes.c_double) for k in _OUT_ORDER),
        _ptr(audit, ctypes.c_int64))
    del keep
    if rc != S:
        raise ValueError(f"native lidar staging failed at message {-rc - 1}")
    return out, tuple(int(x) for x in audit)


def stage_lidar_batch_f32(blobs, *, R_bl, t_bl, min_r, max_r, sigma,
                          sentinel, n_cap, raw_cap, imu, imu_len,
                          accel_scale, odom, prev_t=None, origin=None,
                          margin=16.0, out=None) -> tuple:
    """f32 outputs with the times rebased inline to ``origin`` (None: this
    batch's first scan stamp less ``margin``); the staging math stays f64
    and rounds once on store. scan_start / scan_end come back f64,
    rebased. Returns (out, origin, audit counts)."""
    lib = library()
    S = len(blobs)
    out = (alloc_stage_out(S, n_cap, imu_len, np.float32) if out is None
           else out)
    _check_out(out, S, n_cap, imu_len, np.float32)
    args, keep = _stage_args(blobs, R_bl, t_bl, min_r, max_r, sigma,
                             sentinel, n_cap, raw_cap, imu, imu_len,
                             accel_scale, odom, prev_t)
    audit = np.zeros(3, dtype=np.int64)
    origin_out = np.zeros(1)
    rc = lib.gcio_stage_lidar_batch_f32(
        *args, float("nan") if origin is None else float(origin),
        float(margin), _ptr(origin_out, ctypes.c_double),
        *(_ptr(out[k], ctypes.c_double if k in ("scan_start", "scan_end")
               else ctypes.c_float) for k in _OUT_ORDER),
        _ptr(audit, ctypes.c_int64))
    del keep
    if rc != S:
        raise ValueError(f"native f32 lidar staging failed at message "
                         f"{-rc - 1}")
    return out, float(origin_out[0]), tuple(int(x) for x in audit)
