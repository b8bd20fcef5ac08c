"""Minimal CDR (XCDR1) decoders and encoders for the ROS 2 message types
the pipeline consumes (the port's own copy of ``fl_slam_tpu/io/cdr.py``,
numpy only).

Wire formats: sensor_msgs/msg/Imu, nav_msgs/msg/Odometry,
sensor_msgs/msg/PointCloud2 (header + fields + a zero-copy view of data),
and the camera's CompressedImage / Image.

CDR rules honored: 4-byte encapsulation header (little-endian required),
primitive alignment relative to the byte after the encapsulation header,
strings as uint32 length (including NUL) + bytes.

These are the Python decoders; ``fl_slam_tpu_torch.io.native`` runs the C++
batch decoders of ``src/gcio.cpp`` for the same formats and is tested
against this module.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        if len(buf) < 4:
            raise ValueError("CDR buffer too short")
        rep = buf[1]
        if rep not in (0x01, 0x03):  # CDR_LE / PL_CDR_LE
            raise ValueError(f"big-endian or unknown CDR representation {buf[:2]!r}")
        self.buf = buf
        self.off = 4  # alignment origin is AFTER the encapsulation header

    def _align(self, n: int):
        rel = self.off - 4
        pad = (-rel) % n
        self.off += pad

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<I", self.buf, self.off)[0]
        self.off += 4
        return v

    def i32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<i", self.buf, self.off)[0]
        self.off += 4
        return v

    def f64(self) -> float:
        self._align(8)
        v = struct.unpack_from("<d", self.buf, self.off)[0]
        self.off += 8
        return v

    def f64n(self, n: int) -> np.ndarray:
        self._align(8)
        v = np.frombuffer(self.buf, dtype="<f8", count=n, offset=self.off)
        self.off += 8 * n
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n]
        self.off += n
        return s.rstrip(b"\x00").decode("utf-8", "replace")

    def bytes_seq(self) -> memoryview:
        n = self.u32()
        v = memoryview(self.buf)[self.off:self.off + n]
        self.off += n
        return v


def _header(c: _Cursor) -> float:
    sec = c.i32()
    nsec = c.u32()
    c.string()  # frame_id
    return sec + nsec * 1e-9


class ImuMsg(NamedTuple):
    stamp: float
    gyro: np.ndarray        # (3,)
    accel: np.ndarray       # (3,)


def decode_imu(buf: bytes) -> ImuMsg:
    c = _Cursor(buf)
    stamp = _header(c)
    c.f64n(4)               # orientation quaternion
    c.f64n(9)               # orientation covariance
    gyro = c.f64n(3).copy()
    c.f64n(9)
    accel = c.f64n(3).copy()
    c.f64n(9)
    return ImuMsg(stamp=stamp, gyro=gyro, accel=accel)


class OdomMsg(NamedTuple):
    stamp: float
    position: np.ndarray     # (3,)
    quat_xyzw: np.ndarray    # (4,)
    pose_cov: np.ndarray     # (6, 6)
    vel_body: np.ndarray     # (3,)
    omega_body: np.ndarray   # (3,)
    twist_cov: np.ndarray    # (6, 6)


def decode_odometry(buf: bytes) -> OdomMsg:
    c = _Cursor(buf)
    stamp = _header(c)
    c.string()               # child_frame_id
    pos = c.f64n(3).copy()
    quat = c.f64n(4).copy()
    pose_cov = c.f64n(36).copy().reshape(6, 6)
    vel = c.f64n(3).copy()
    omega = c.f64n(3).copy()
    twist_cov = c.f64n(36).copy().reshape(6, 6)
    return OdomMsg(stamp=stamp, position=pos, quat_xyzw=quat,
                   pose_cov=pose_cov, vel_body=vel, omega_body=omega,
                   twist_cov=twist_cov)


class PointField(NamedTuple):
    name: str
    offset: int
    datatype: int
    count: int


class PointCloud2Msg(NamedTuple):
    stamp: float
    height: int
    width: int
    fields: tuple
    point_step: int
    row_step: int
    data: memoryview
    is_dense: bool


def decode_pointcloud2(buf: bytes) -> PointCloud2Msg:
    c = _Cursor(buf)
    stamp = _header(c)
    height = c.u32()
    width = c.u32()
    n_fields = c.u32()
    fields = []
    for _ in range(n_fields):
        name = c.string()
        off = c.u32()
        dtype = c.u8()
        count = c.u32()
        fields.append(PointField(name, off, dtype, count))
    is_bigendian = c.u8()
    if is_bigendian:
        raise ValueError("big-endian PointCloud2 unsupported")
    point_step = c.u32()
    row_step = c.u32()
    data = c.bytes_seq()
    is_dense = bool(c.u8())
    return PointCloud2Msg(stamp=stamp, height=height, width=width,
                          fields=tuple(fields), point_step=point_step,
                          row_step=row_step, data=data, is_dense=is_dense)


# PointField datatype codes (sensor_msgs/PointField).
_PF_NP = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
          7: "f4", 8: "f8"}


def pointcloud2_fields(msg: PointCloud2Msg, names):
    """Extract named fields as a dict of (N,) numpy arrays via strided views
    (parity: backend_node.parse_pointcloud2_vlp16's numpy struct view)."""
    n = msg.width * msg.height
    raw = np.frombuffer(msg.data, dtype=np.uint8,
                        count=n * msg.point_step).reshape(n, msg.point_step)
    out = {}
    by_name = {f.name: f for f in msg.fields}
    for name in names:
        f = by_name.get(name)
        if f is None:
            out[name] = None
            continue
        np_dt = np.dtype("<" + _PF_NP[f.datatype])
        w = np_dt.itemsize
        out[name] = raw[:, f.offset:f.offset + w].copy().view(np_dt).reshape(n)
    return out


# ---------------------------------------------------------------------------
# Encoders (tests + synthetic bag construction only).
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.parts = bytearray(b"\x00\x01\x00\x00")

    def _align(self, n):
        rel = len(self.parts) - 4
        self.parts.extend(b"\x00" * ((-rel) % n))

    def u8(self, v):
        self.parts.append(v & 0xFF)

    def u32(self, v):
        self._align(4)
        self.parts.extend(struct.pack("<I", v))

    def i32(self, v):
        self._align(4)
        self.parts.extend(struct.pack("<i", v))

    def f64(self, v):
        self._align(8)
        self.parts.extend(struct.pack("<d", v))

    def f64n(self, arr):
        self._align(8)
        self.parts.extend(np.asarray(arr, dtype="<f8").tobytes())

    def string(self, s: str):
        b = s.encode() + b"\x00"
        self.u32(len(b))
        self.parts.extend(b)

    def bytes_seq(self, b: bytes):
        self.u32(len(b))
        self.parts.extend(b)

    def header(self, stamp: float, frame: str = "f"):
        sec = int(stamp)
        self.i32(sec)
        self.u32(int(round((stamp - sec) * 1e9)))
        self.string(frame)


def encode_imu(stamp, gyro, accel) -> bytes:
    w = _Writer()
    w.header(stamp)
    w.f64n(np.zeros(4))
    w.f64n(np.zeros(9))
    w.f64n(gyro)
    w.f64n(np.zeros(9))
    w.f64n(accel)
    w.f64n(np.zeros(9))
    return bytes(w.parts)


def encode_odometry(stamp, position, quat_xyzw, pose_cov, vel_body,
                    omega_body, twist_cov) -> bytes:
    w = _Writer()
    w.header(stamp)
    w.string("base")
    w.f64n(position)
    w.f64n(quat_xyzw)
    w.f64n(np.asarray(pose_cov).reshape(-1))
    w.f64n(vel_body)
    w.f64n(omega_body)
    w.f64n(np.asarray(twist_cov).reshape(-1))
    return bytes(w.parts)


def encode_pointcloud2(stamp, xyz, ring=None, point_time=None) -> bytes:
    """VLP-16-style cloud: x,y,z f32 + ring u16 + time f32."""
    xyz = np.asarray(xyz, dtype="<f4")
    n = xyz.shape[0]
    fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1),
              ("ring", 12, 4, 1), ("time", 16, 7, 1)]
    step = 20
    raw = np.zeros((n, step), dtype=np.uint8)
    raw[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    ring = np.zeros(n, dtype="<u2") if ring is None else np.asarray(ring, "<u2")
    raw[:, 12:14] = ring.view(np.uint8).reshape(n, 2)
    pt = (np.zeros(n, "<f4") if point_time is None
          else np.asarray(point_time, "<f4"))
    raw[:, 16:20] = pt.view(np.uint8).reshape(n, 4)

    w = _Writer()
    w.header(stamp)
    w.u32(1)        # height
    w.u32(n)        # width
    w.u32(len(fields))
    for name, off, dt, cnt in fields:
        w.string(name)
        w.u32(off)
        w.u8(dt)
        w.u32(cnt)
    w.u8(0)         # is_bigendian
    w.u32(step)
    w.u32(step * n)
    w.bytes_seq(raw.tobytes())
    w.u8(1)         # is_dense
    return bytes(w.parts)


# ---------------------------------------------------------------------------
# Camera wire formats (parity: reference src/camera_rgbd_node.cpp:49-90 —
# compressed RGB + raw 16UC1 depth in, stamp-paired RGBD out).
# ---------------------------------------------------------------------------


class CompressedImageMsg(NamedTuple):
    stamp: float
    format: str              # e.g. "rgb8; jpeg compressed bgr8"
    data: bytes              # the compressed payload (JPEG/PNG)


def decode_compressed_image(buf: bytes) -> CompressedImageMsg:
    """sensor_msgs/msg/CompressedImage."""
    c = _Cursor(buf)
    stamp = _header(c)
    fmt = c.string()
    data = bytes(c.bytes_seq())
    return CompressedImageMsg(stamp=stamp, format=fmt, data=data)


class ImageMsg(NamedTuple):
    stamp: float
    height: int
    width: int
    encoding: str            # e.g. "16UC1", "rgb8"
    step: int
    data: memoryview


def decode_image(buf: bytes) -> ImageMsg:
    """sensor_msgs/msg/Image (raw)."""
    c = _Cursor(buf)
    stamp = _header(c)
    height = c.u32()
    width = c.u32()
    encoding = c.string()
    c.u8()                   # is_bigendian
    step = c.u32()
    data = c.bytes_seq()
    return ImageMsg(stamp=stamp, height=height, width=width,
                    encoding=encoding, step=step, data=data)


def depth_image_to_m(msg: ImageMsg) -> np.ndarray:
    """Depth image -> (H, W) float32 meters (16UC1 mm or 32FC1 m; parity:
    camera_rgbd_node.cpp mm->m conversion / depth_passthrough.py)."""
    if msg.encoding in ("16UC1", "mono16"):
        d = np.frombuffer(msg.data, dtype="<u2").reshape(msg.height,
                                                         msg.width)
        return d.astype(np.float32) * 1e-3
    if msg.encoding == "32FC1":
        return np.frombuffer(msg.data, dtype="<f4").reshape(
            msg.height, msg.width).copy()
    raise ValueError(f"unsupported depth encoding {msg.encoding!r}")


def encode_compressed_image(stamp: float, payload: bytes,
                            fmt: str = "rgb8; jpeg compressed bgr8") -> bytes:
    w = _Writer()
    w.header(stamp)
    w.string(fmt)
    w.bytes_seq(payload)
    return bytes(w.parts)


def encode_image(stamp: float, array: np.ndarray, encoding: str) -> bytes:
    """Raw image encoder (tests/synthetic bags): 16UC1 (H, W) u16 or rgb8."""
    if encoding in ("16UC1", "mono16"):
        raw = np.ascontiguousarray(array, dtype="<u2")
        step = raw.shape[1] * 2
    elif encoding == "rgb8":
        raw = np.ascontiguousarray(array, dtype=np.uint8)
        step = raw.shape[1] * 3
    else:
        raise ValueError(encoding)
    w = _Writer()
    w.header(stamp)
    w.u32(array.shape[0])
    w.u32(array.shape[1])
    w.string(encoding)
    w.u8(0)
    w.u32(step)
    w.bytes_seq(raw.tobytes())
    return bytes(w.parts)
