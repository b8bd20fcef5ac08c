"""Line-plot dashboards drawn with PIL (the port's twins of
``tools/run_eval.py``'s matplotlib dashboards, ``_dashboard_mpl`` and the
effect panel of ``_effect_dashboard``). The panels, their series and their
titles are the reference's; the drawing is a plain grid of line plots,
since the card's machine has PIL and no matplotlib.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40))
PANEL_WH = (660, 440)      # the reference's panels: 6 x 4 in at 110 dpi
MARGIN = (70, 30, 20, 40)         # left, top, right, bottom (px)


class Series(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    label: str | None = None
    dashed: bool = False


class Panel(NamedTuple):
    title: str
    series: tuple
    equal: bool = False           # equal axis scales (a trajectory)


def _span(vals, equal_to=None):
    v = np.concatenate([a[np.isfinite(a)] for a in vals] or [np.zeros(1)])
    lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)
    if hi - lo < 1e-12:
        lo, hi = lo - 0.5, hi + 0.5
    pad = 0.05 * (hi - lo)
    return lo - pad, hi + pad


def _segments(pts, dashed: bool):
    """Runs of finite points; dashed lines keep every other 8-px dash."""
    ok = np.isfinite(pts).all(1)
    runs, cur = [], []
    for p, good in zip(pts, ok):
        if good:
            cur.append(tuple(p))
        elif cur:
            runs.append(cur)
            cur = []
    if cur:
        runs.append(cur)
    if not dashed:
        return runs
    out = []
    for run in runs:
        for a, b in zip(run[:-1], run[1:]):
            n = max(1, int(np.hypot(b[0] - a[0], b[1] - a[1]) // 8))
            for i in range(0, n, 2):
                t0, t1 = i / n, min(i + 1, n) / n
                out.append([(a[0] + t0 * (b[0] - a[0]),
                             a[1] + t0 * (b[1] - a[1])),
                            (a[0] + t1 * (b[0] - a[0]),
                             a[1] + t1 * (b[1] - a[1]))])
    return out


def _draw_panel(draw, font, x0: int, y0: int, panel: Panel) -> None:
    W, H = PANEL_WH
    ml, mt, mr, mb = MARGIN
    ax0, ay0, ax1, ay1 = x0 + ml, y0 + mt, x0 + W - mr, y0 + H - mb
    draw.rectangle([ax0, ay0, ax1, ay1], outline=(0, 0, 0))
    draw.text(((ax0 + ax1) / 2, y0 + 6), panel.title, fill=(0, 0, 0),
              font=font, anchor="mt")
    xs = [np.asarray(s.x, np.float64) for s in panel.series]
    ys = [np.asarray(s.y, np.float64) for s in panel.series]
    xlo, xhi = _span(xs)
    ylo, yhi = _span(ys)
    if panel.equal:
        sx, sy = (xhi - xlo) / (ax1 - ax0), (yhi - ylo) / (ay1 - ay0)
        if sx > sy:
            c = 0.5 * (ylo + yhi)
            ylo, yhi = c - 0.5 * sx * (ay1 - ay0), c + 0.5 * sx * (ay1 - ay0)
        else:
            c = 0.5 * (xlo + xhi)
            xlo, xhi = c - 0.5 * sy * (ax1 - ax0), c + 0.5 * sy * (ax1 - ax0)
    for f in (0.0, 0.5, 1.0):
        xv, yv = xlo + f * (xhi - xlo), ylo + f * (yhi - ylo)
        px, py = ax0 + f * (ax1 - ax0), ay1 - f * (ay1 - ay0)
        draw.line([px, ay1, px, ay1 + 4], fill=(0, 0, 0))
        draw.text((px, ay1 + 6), f"{xv:.4g}", fill=(0, 0, 0), font=font,
                  anchor="mt")
        draw.line([ax0 - 4, py, ax0, py], fill=(0, 0, 0))
        draw.text((ax0 - 6, py), f"{yv:.4g}", fill=(0, 0, 0), font=font,
                  anchor="rm")
    ly = ay0 + 6
    for i, (s, x, y) in enumerate(zip(panel.series, xs, ys)):
        color = COLORS[i % len(COLORS)]
        pts = np.stack([ax0 + (x - xlo) / (xhi - xlo) * (ax1 - ax0),
                        ay1 - (y - ylo) / (yhi - ylo) * (ay1 - ay0)], 1)
        for seg in _segments(pts, s.dashed):
            if len(seg) > 1:
                draw.line(seg, fill=color, width=2)
        if s.label:
            draw.line([ax1 - 150, ly + 5, ax1 - 125, ly + 5], fill=color,
                      width=2)
            draw.text((ax1 - 120, ly), s.label, fill=(0, 0, 0), font=font)
            ly += 16


def save_panels(path: str, panels, cols: int = 2) -> str:
    """Draw ``panels`` (a list of ``Panel``) on a grid of ``cols`` columns
    and write the PNG ``path``."""
    from PIL import Image, ImageDraw, ImageFont

    rows = -(-len(panels) // cols)
    W, H = PANEL_WH
    img = Image.new("RGB", (cols * W, rows * H), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    font = ImageFont.load_default(size=13)
    for i, p in enumerate(panels):
        _draw_panel(draw, font, (i % cols) * W, (i // cols) * H, p)
    img.save(path)
    return path


def dashboard_panels(certs: dict, poses, gt_poses, stamps) -> list:
    """The four panels of the reference's ``_dashboard_mpl``
    (``tools/run_eval.py:517``)."""
    t = np.asarray(stamps)
    traj = [Series(poses[:, 0], poses[:, 1], "est")]
    if gt_poses is not None:
        traj.append(Series(gt_poses[:, 0], gt_poses[:, 1], "gt", True))
    return [
        Panel("trajectory (xy)", tuple(traj), equal=True),
        Panel("|odom residual|",
              (Series(t, certs["odom_pose.residual_norm"]),)),
        Panel("map size/insertions",
              (Series(t, np.cumsum(certs["map.inserted_count"]),
                      "cum inserted"),
               Series(t, certs["map.merged_pairs"], "merged/scan"))),
        Panel("tempering / trust",
              (Series(t, certs["temper.beta"], "beta"),
               Series(t, certs["fusion.alpha"], "alpha"))),
    ]


def effect_panels(pairs: dict, stamps) -> list:
    """Predicted against realized objective per operator, as the
    reference's ``_effect_dashboard`` (``tools/run_eval.py:466``)."""
    t = np.asarray(stamps)
    return [Panel(op, (Series(t, p, "predicted"),
                       Series(t, r, "realized", True)))
            for op, (p, r) in sorted(pairs.items())]
