"""Render a ``splat_export.npz`` map to a PNG (the port's twin of
``tools/view_splat.py``), through K8: ``render.splat_kernels.render_tiled``
launches stage 1 (``bin_tiles``) and stage 2 (``composite``) once each per
image on the card; with ``--cpu`` it runs their plain twins.

  python -m fl_slam_tpu_torch.render.view_splat runs/eval1 --out map.png
      [--pose-idx -1] [--behind 2.0] [--above 1.0] [--wh 960 720]
      [--fov-deg 70] [--bev] [--max-prims 16384] [--cpu]

The camera defaults to a chase view: ``--behind`` meters behind and
``--above`` meters above the selected trajectory pose, looking 2 m ahead
of it. ``--bev`` (or an export without a trajectory) renders a top-down
view of the whole map. The map is cut to its top ``--max-prims``
primitives by weight; a map of uniform color is tinted by height.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from fl_slam_tpu_torch.core import se3
from fl_slam_tpu_torch.render import splat, splat_kernels
from fl_slam_tpu_torch.runtime import resolve_device


def resolve_npz(path: str) -> str:
    """``path`` itself, or the ``splat_export.npz`` of a run directory."""
    if os.path.isdir(path):
        path = os.path.join(path, "splat_export.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no splat export at {path}")
    return path


def chase_camera(pose, behind: float, above: float, width: int,
                 height: int, fov_deg: float, device=None) -> splat.Camera:
    """Camera-to-world pose looking along +x of ``pose`` [t, rotvec], from
    ``behind`` m behind and ``above`` m above it
    (parity: ``tools/view_splat.py:40``)."""
    pose = torch.as_tensor(np.asarray(pose), dtype=torch.float64)
    fwd = se3.so3_exp(pose[3:6])[:, 0]
    eye = pose[:3] - behind * fwd + torch.tensor([0.0, 0.0, above],
                                                 dtype=torch.float64)
    z = pose[:3] + 2.0 * fwd - eye
    z = z / torch.linalg.norm(z)
    x = torch.linalg.cross(z, torch.tensor([0.0, 0.0, 1.0],
                                           dtype=torch.float64))
    x = x / torch.clamp(torch.linalg.norm(x), min=1e-9)
    y = torch.linalg.cross(z, x)
    R_wc = torch.stack([x, y, z], 1)    # +z to the target, +x right, +y down
    f = 0.5 * width / math.tan(math.radians(fov_deg) / 2.0)
    pose_wc = torch.cat([eye, se3.so3_log(R_wc)])
    return splat.Camera(pose_wc=pose_wc.to(device=resolve_device(device),
                                           dtype=torch.float32),
                        fx=f, fy=f, cx=width / 2.0, cy=height / 2.0,
                        width=width, height=height)


def load_primitives(npz_path: str, max_prims: int):
    """(positions, Lambdas, etas, rgb, weights, n in the export, the
    export): the top ``max_prims`` by weight, a uniform color tinted by
    height (the reference viewer's cut and tint)."""
    d = np.load(npz_path)
    pos, Lam = d["positions"], d["Lambdas"]
    etas, rgb, w = d["etas"], d["rgb"], d["weights"]
    n = pos.shape[0]
    if n == 0:
        raise ValueError(f"{npz_path} holds no valid primitives")
    if n > max_prims:
        keep = np.argsort(-w)[:max_prims]
        pos, Lam, etas, rgb, w = (a[keep] for a in (pos, Lam, etas, rgb, w))
    if rgb.std() < 1e-3:
        z = pos[:, 2]
        zn = (z - np.percentile(z, 5)) / max(
            np.percentile(z, 95) - np.percentile(z, 5), 1e-6)
        zn = np.clip(zn, 0.0, 1.0)[:, None]
        rgb = (np.array([0.20, 0.35, 0.75]) * (1 - zn)
               + np.array([0.95, 0.75, 0.25]) * zn)
    return pos, Lam, etas, rgb, w, n, d


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Auto-exposure to the 99th percentile (vMF shading dims off-lobe
    views), then 8 bits."""
    p99 = np.percentile(img, 99)
    if 1e-6 < p99 < 0.5:
        img = img / p99 * 0.85
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def render_export(path: str, out: str | None = None, *, pose_idx: int = -1,
                  behind: float = 2.0, above: float = 1.0,
                  wh=(960, 720), fov_deg: float = 70.0, bev: bool = False,
                  max_prims: int = 16384, device=None) -> dict:
    """Render the export at ``path`` (a run directory or the npz) to the
    PNG ``out`` (default: ``map_render.png`` beside it) on ``device``
    (default: the card). Returns the image (uint8), the primitive counts,
    the render's wall ms (until the image is on the host) and, on the
    card, its peak device memory."""
    from PIL import Image

    dev = resolve_device(device)
    npz_path = resolve_npz(path)
    out = out or os.path.join(os.path.dirname(npz_path), "map_render.png")
    pos, Lam, etas, rgb, w, n, d = load_primitives(npz_path, max_prims)
    W, H = wh
    if bev or "trajectory" not in d:
        cam = splat.bev_camera(pos, W, H, device=dev)
        view = "bev"
    else:
        cam = chase_camera(d["trajectory"][pose_idx], behind, above, W, H,
                           fov_deg, device=dev)
        view = f"pose {pose_idx}"
    prims = tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev)
                  for a in (pos, Lam, etas, rgb, w)) + (
        torch.ones((pos.shape[0],), dtype=torch.bool, device=dev),)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    img, _ = splat_kernels.render_tiled(*prims, cam)
    img = img.cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    img8 = to_uint8(img)
    Image.fromarray(img8).save(out)
    res = {"out": out, "image": img8, "n_prims": int(n),
           "n_rendered": int(pos.shape[0]), "render_ms": ms, "view": view}
    if dev.type == "cuda":
        res["peak_mb"] = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
    return res


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fl_slam_tpu_torch.render.view_splat")
    ap.add_argument("path", help="run directory or splat_export.npz")
    ap.add_argument("--out", default=None)
    ap.add_argument("--pose-idx", type=int, default=-1)
    ap.add_argument("--behind", type=float, default=2.0)
    ap.add_argument("--above", type=float, default=1.0)
    ap.add_argument("--wh", type=int, nargs=2, default=(960, 720))
    ap.add_argument("--fov-deg", type=float, default=70.0)
    ap.add_argument("--bev", action="store_true")
    ap.add_argument("--max-prims", type=int, default=16384)
    ap.add_argument("--cpu", action="store_true",
                    help="render with the plain twins on the CPU")
    return ap


def main(argv=None) -> dict:
    a = _parser().parse_args(argv)
    res = render_export(a.path, a.out, pose_idx=a.pose_idx, behind=a.behind,
                        above=a.above, wh=tuple(a.wh), fov_deg=a.fov_deg,
                        bev=a.bev, max_prims=a.max_prims,
                        device="cpu" if a.cpu else None)
    print(f"[view_splat] {res['n_prims']} prims ({res['n_rendered']} "
          f"rendered) -> {res['out']} ({res['view']}, "
          f"{res['render_ms']:.1f} ms)", flush=True)
    return res


if __name__ == "__main__":
    main()
