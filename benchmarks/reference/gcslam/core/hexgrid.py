"""Hex tiling and local hex-cell binning (port of
``fl_slam_tpu/core/hexgrid.py``): world (x, y, z) -> axial (q, r) + z slab,
packed into one int64 tile key; the bounded local surfel grid."""

from __future__ import annotations

import numpy as np
import torch

SQRT3 = 1.7320508075688772


def xy_to_axial_frac(x, y, size):
    q = (SQRT3 / 3.0 * x - y / 3.0) / size
    r = (2.0 / 3.0 * y) / size
    return q, r


def axial_round(qf, rf):
    """Cube rounding (branch-free; round half to even as the reference)."""
    xf, zf = qf, rf
    yf = -xf - zf
    rx, ry, rz = torch.round(xf), torch.round(yf), torch.round(zf)
    dx, dy, dz = torch.abs(rx - xf), torch.abs(ry - yf), torch.abs(rz - zf)
    fix_x = (dx > dy) & (dx > dz)
    fix_y = (~fix_x) & (dy > dz)
    rx = torch.where(fix_x, -ry - rz, rx)
    ry = torch.where(fix_y, -rx - rz, ry)
    rz = -rx - ry
    return rx.to(torch.int32), rz.to(torch.int32)


def xyz_to_tile_axial(p, h_tile: float, h_z: float | None = None):
    if h_z is None:
        h_z = h_tile
    qf, rf = xy_to_axial_frac(p[..., 0], p[..., 1], h_tile)
    q, r = axial_round(qf, rf)
    zi = torch.floor(p[..., 2] / h_z + 0.5).to(torch.int32)
    return q, r, zi


_BIAS = 1 << 20
_SHIFT_Q = 42
_SHIFT_R = 21


def pack_tile_key(q, r, z):
    q64 = q.to(torch.int64) + _BIAS
    r64 = r.to(torch.int64) + _BIAS
    z64 = z.to(torch.int64) + _BIAS
    return (q64 << _SHIFT_Q) | (r64 << _SHIFT_R) | z64


def unpack_tile_key(key):
    """int64 tile key -> int32 (q, r, z)
    (parity: ``fl_slam_tpu/core/hexgrid.py:80``)."""
    z = (key & ((1 << _SHIFT_R) - 1)) - _BIAS
    r = ((key >> _SHIFT_R) & ((1 << _SHIFT_R) - 1)) - _BIAS
    q = (key >> _SHIFT_Q) - _BIAS
    return q.to(torch.int32), r.to(torch.int32), z.to(torch.int32)


def tile_keys_from_xyz(p, h_tile: float, h_z: float | None = None):
    return pack_tile_key(*xyz_to_tile_axial(p, h_tile, h_z))


def hex_disk_offsets(radius: int) -> np.ndarray:
    offs = [(0, 0)]
    for rad in range(1, radius + 1):
        q, r = rad, 0
        for dq, dr in [(-1, 1), (-1, 0), (0, -1), (1, -1), (1, 0), (0, 1)]:
            for _ in range(rad):
                offs.append((q, r))
                q += dq
                r += dr
    return np.asarray(offs, dtype=np.int32)


def stencil_offsets_3d(r_xy: int, r_z: int) -> np.ndarray:
    disk = hex_disk_offsets(r_xy)
    return np.asarray([(dq, dr, dz) for dz in range(-r_z, r_z + 1)
                       for dq, dr in disk], dtype=np.int32)


def stencil_tile_keys(center_q, center_r, center_z, offsets):
    """offsets: (S, 3) int tensor on the centers' device -> (..., S) keys."""
    q = center_q[..., None] + offsets[:, 0]
    r = center_r[..., None] + offsets[:, 1]
    z = center_z[..., None] + offsets[:, 2]
    return pack_tile_key(q, r, z)


def bin_cell_ids(p, cell_size: float, c1: int, c2: int, cz: int,
                 z_size: float | None = None):
    """Per-point flat cell id on the wrapped hex lattice, in [0, c1 c2 cz)
    (parity: ``fl_slam_tpu/core/hexgrid.py:133``)."""
    if z_size is None:
        z_size = cell_size
    q, r, zi = xyz_to_tile_axial(p, cell_size, z_size)
    return ((torch.remainder(q, c1) * c2 + torch.remainder(r, c2)) * cz
            + torch.remainder(zi, cz))


def bin_cell_ids_local(x, y, z, cell_size, c1: int, c2: int, cz: int,
                       z_size=None):
    """Bounded local hex grid (clipped, not wrapped): (ids, in_grid)."""
    if z_size is None:
        z_size = cell_size
    qf, rf = xy_to_axial_frac(x, y, cell_size)
    q, r = axial_round(qf, rf)
    zi = torch.floor(z / z_size + 0.5).to(torch.int32)
    qo, ro, zo = q + c1 // 2, r + c2 // 2, zi + cz // 2
    in_grid = ((qo >= 0) & (qo < c1) & (ro >= 0) & (ro < c2)
               & (zo >= 0) & (zo < cz))
    qc = torch.clamp(qo, 0, c1 - 1)
    rc = torch.clamp(ro, 0, c2 - 1)
    zc = torch.clamp(zo, 0, cz - 1)
    return (qc * c2 + rc) * cz + zc, in_grid


def cell_centers_from_ids(cell, cell_size, c1: int, c2: int, cz: int,
                          z_size=None, dtype=torch.float32):
    """Cell center coordinates of flat ids (inverse of the flattening)."""
    if z_size is None:
        z_size = cell_size
    cell = cell.to(torch.int32)
    qo = cell // (c2 * cz)
    ro = (cell // cz) % c2
    zo = cell % cz
    q = (qo - c1 // 2).to(dtype)
    r = (ro - c2 // 2).to(dtype)
    zi = (zo - cz // 2).to(dtype)
    return (cell_size * SQRT3 * (q + 0.5 * r), cell_size * 1.5 * r,
            zi * z_size)
