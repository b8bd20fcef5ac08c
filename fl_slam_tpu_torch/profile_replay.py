"""Where the time of the port's replay goes, on one CUDA device.

  python3 -m fl_slam_tpu_torch.profile_replay [--belief-kernel on|off|both]
                                             [--select-kernel on|off|both]
                                             [--instances B]

Replays ``GCConfig.tpu()`` (``on``, the default: the belief kernels K1/K2
carry the belief chain), ``GCConfig.tpu(belief_kernel=False)`` (``off``:
the chain op by op) or both in one process, over 20 synthetic drifting-
odometry scans (seed 3) after a warm-up replay, and prints one JSON line per
configuration (``--select-kernel on`` adds ``select_kernel=True``: K9 in
the association): the host-clock ms/scan of 3 unprofiled replays, then, from
one replay under ``torch.profiler`` (CUDA activity only), the device kernel
time per scan, the kernel launches per scan, the device busy share over
that replay's own span (its first launch to its last device completion,
from the profiler's raw records), the kernels that take the most device
time, among them each hand-written kernel of the port (device us per
call), each port kernel's launches as the profiler counted them
beside the port's own ``launches`` counters from the same replay
(``port_counts``; the script exits non-zero when they differ), the host ms
of each of the port's spans (``tracing``: total and self, per scan), and
every device-idle gap of 0.5 ms or more named by the innermost span it
falls in, with the share of the idle time that no span below a root call
(``pipeline.replay``) covers. With
``--instances B`` (B > 1) it profiles the instance-batched
replay (``parallel.replicas.batched_replay``) of B instances (seeds 3 ..
3 + B - 1) the same way: every per-scan figure is then per batched scan,
which advances all B instances by one scan.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

N_SCANS = 20
N_REPS = 3
# The port's hand-written kernels (csrc/) by their device symbol, each with
# the launch counters (module, key, device launches per count) that count
# it: an exchange is one launch (flush and gather in one pass); K4 is two
# kernels (sort-and-reduce, then gather) counted once, and so is K9 (the
# chunks' top 2, then the top k).
_K4_KEYS = ("surfels", "fuse", "surfels_batched", "fuse_batched")
KERNEL_COUNTERS = {
    "pe_kernel": (("belief_kernels", "predict_evidence", 1),
                  ("belief_kernels", "predict_evidence_batched", 1)),
    "tail_kernel": (("belief_kernels", "scalar_tail", 1),
                    ("belief_kernels", "scalar_tail_batched", 1)),
    "sinkhorn_cluster": (("assoc_kernels", "sinkhorn_piT", 1),
                         ("assoc_kernels", "sinkhorn_piT_batched", 1)),
    "moment_sort_reduce": tuple(("surfel_kernels", k, 1) for k in _K4_KEYS),
    "moment_gather": tuple(("surfel_kernels", k, 1) for k in _K4_KEYS),
    "exchange_pass": tuple(("atlas_kernels", k, 1) for k in (
        "exchange_ff", "exchange_ff_batched", "exchange",
        "exchange_batched")),
    "page_kernel": (("atlas_kernels", "page_gather", 1),
                    ("atlas_kernels", "page_writeback", 1)),
    "select_kernel": (("assoc_kernels", "select_candidates", 1),
                      ("assoc_kernels", "select_candidates_batched", 1)),
    "select_topk_kernel": (("assoc_kernels", "select_candidates", 1),
                           ("assoc_kernels", "select_candidates_batched", 1)),
    "pose6_cond_kernel": (("belief_kernels", "pose6_cond", 1),
                          ("belief_kernels", "pose6_cond_batched", 1)),
    "imu_window_kernel": (("belief_kernels", "imu_window", 1),
                          ("belief_kernels", "imu_window_batched", 1)),
}
OWN_KERNELS = tuple(KERNEL_COUNTERS)


def own_kernel(key: str):
    """The port kernel's symbol in a profiler event key
    (``void (anonymous namespace)::moment_gather<float>(...)``), or None."""
    for k in OWN_KERNELS:
        if f"::{k}<" in key:
            return k
    return None


def reconcile(events, counters: dict) -> list:
    """Hold the profiler's launches of each port kernel against the port's
    own counters from the same run. ``events`` are (key, count) pairs of
    the profiler's device kernels; ``counters`` maps a module name to its
    ``launches`` dict. Returns one row per port kernel seen by either side:
    name, profiler count, port count and whether they agree."""
    seen = {}
    for key, count in events:
        k = own_kernel(key)
        if k is not None:
            seen[k] = seen.get(k, 0) + count
    rows = []
    for k, refs in KERNEL_COUNTERS.items():
        port = sum(counters[mod][key] * per for mod, key, per in refs)
        prof = seen.get(k, 0)
        if port or prof:
            rows.append({"name": k, "profiler": prof, "port": port,
                         "agree": prof == port})
    return rows


# The profiler can drop the last few hundred kernel records of a trace (a
# batched profile once lost the final scan's last 5 port kernels: tail
# truncation). The replay is therefore followed, inside the trace, by a
# trailer of empty kernels (``torch.cuda._sleep``, device symbol
# ``spin_kernel``) that the figures leave out, so that a truncation falls
# on the trailer; ``reconcile`` shows whether it did.
_TRAILER = "spin_kernel"
_TRAILER_LAUNCHES = 30000


def _trailer() -> None:
    import torch
    for _ in range(_TRAILER_LAUNCHES):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    time.sleep(0.2)


def device_records(events) -> tuple:
    """(device records [(name, start_ns, end_ns)] without the trailer, the
    host launch records' start times) of the profiler's raw records."""
    from torch.autograd import DeviceType
    dev, launches = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if _TRAILER not in e.name():
                dev.append((e.name(), e.start_ns(),
                            e.start_ns() + e.duration_ns()))
        elif e.name().startswith("cu") and "Launch" in e.name():
            launches.append(e.start_ns())
    return dev, launches


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a: int, b: int, merged) -> int:
    return sum(max(0, min(b, e) - max(a, s)) for s, e in merged)


def busy_share(dev, t0: int) -> float:
    """The share of [t0, the last device completion] in which some device
    record ran."""
    end = max(e for _, _, e in dev)
    busy = sum(e - s for s, e in _union((s, e) for _, s, e in dev))
    return busy / (end - t0)


def _depths(spans) -> dict:
    by_id = {s.id: s for s in spans}
    depth = {}
    for s in spans:
        d, p = 0, s.parent
        while p in by_id:
            d, p = d + 1, by_id[p].parent
        depth[s.id] = d
    return depth


def host_ms_by_span(spans, n_scans: int) -> dict:
    """{name: {total, self (total less the time its children cover),
    count}} of the port's spans, ms per scan."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        row = out.setdefault(s.name, {"total_ms_per_scan": 0.0,
                                      "self_ms_per_scan": 0.0, "count": 0})
        dur = s.end_ns - s.start_ns
        covered = _overlap(s.start_ns, s.end_ns,
                           _union(kids.get(s.id, ())))
        row["total_ms_per_scan"] += dur * 1e-6 / n_scans
        row["self_ms_per_scan"] += (dur - covered) * 1e-6 / n_scans
        row["count"] += 1
    return out


def idle_gaps(dev, t0: int, spans, min_ms: float = 0.5) -> tuple:
    """(every device-idle gap in [t0, the last device completion] of at
    least ``min_ms``, longest first, each named by the innermost span
    that holds its midpoint ("none" outside every span); the share of all
    idle time that no span below a root covers)."""
    busy = _union((s, e) for _, s, e in dev)
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    depth = _depths(spans)
    below = _union((s.start_ns, s.end_ns) for s in spans if depth[s.id])
    idle = sum(b - a for a, b in gaps)
    uncovered = sum((b - a) - _overlap(a, b, below) for a, b in gaps)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1]):
        if (b - a) * 1e-6 < min_ms:
            break
        mid = (a + b) // 2
        inner = max((s for s in spans if s.start_ns <= mid <= s.end_ns),
                    key=lambda s: depth[s.id], default=None)
        named.append({"ms": (b - a) * 1e-6, "at_ms": (a - t0) * 1e-6,
                      "span": inner.name if inner else "none"})
    return named, (uncovered / idle if idle else 0.0)


def _counters() -> dict:
    from fl_slam_tpu_torch.ops import (assoc_kernels, belief_kernels,
                                       surfel_kernels)
    from fl_slam_tpu_torch.structures import atlas_kernels
    return {"assoc_kernels": assoc_kernels.launches,
            "belief_kernels": belief_kernels.launches,
            "surfel_kernels": surfel_kernels.launches,
            "atlas_kernels": atlas_kernels.launches}


def _runner(cfg, n_instances: int):
    """(fresh states, replay fn, scans) for one instance or B batched."""
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.parallel import replicas
    from fl_slam_tpu_torch.pipeline import init_state, replay

    dss = [simulate(cfg, n_scans=N_SCANS, seed=3 + i,
                    odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
           for i in range(n_instances)]
    if n_instances == 1:
        ds = dss[0]
        return (lambda: init_state(cfg, anchor0=ds.gt_poses[0],
                                   t0=float(ds.gt_stamps[0]) - 0.1),
                lambda st, sc: replay(st, sc, cfg), to_scan_inputs(ds, cfg))
    mesh = replicas.make_mesh()
    run = replicas.batched_replay(cfg, mesh)
    scans = replicas.shard_scan_inputs(replicas.stack_instances(
        [to_scan_inputs(ds, cfg) for ds in dss]), mesh)
    return (lambda: replicas.init_states_batched(
        cfg, n_instances, anchors0=[ds.gt_poses[0] for ds in dss],
        t0=[float(ds.gt_stamps[0]) - 0.1 for ds in dss], mesh=mesh),
        run, scans)


def profile(belief_kernel: bool, card: str, n_instances: int = 1,
            select_kernel: bool = False) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from fl_slam_tpu_torch import tracing
    from fl_slam_tpu_torch.config import GCConfig

    cfg = GCConfig.tpu(belief_kernel=belief_kernel,
                       select_kernel=select_kernel)
    fresh, replay, scans = _runner(cfg, n_instances)

    replay(fresh(), scans)
    torch.cuda.synchronize()
    walls = []
    for _ in range(N_REPS):
        st = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay(st, scans)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / N_SCANS * 1e3)

    st = fresh()
    torch.cuda.synchronize()
    counters = _counters()
    for c in counters.values():
        for k in c:
            c[k] = 0
    tracing.reset()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        replay(st, scans)
        torch.cuda.synchronize()
        _trailer()
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0 and _TRAILER not in e.key]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    own = [e for e in kernels if own_kernel(e.key) is not None]
    counts = reconcile([(e.key, e.count) for e in kernels], counters)
    spans = tracing.spans()
    dev, launches = device_records(prof.profiler.kineto_results.events())
    t0 = min(launches) if launches else min(s for _, s, _ in dev)
    gaps, uncovered = idle_gaps(dev, t0, spans)
    args = ([] if belief_kernel else ["belief_kernel=False"]) + (
        ["select_kernel=True"] if select_kernel else [])
    label = f"GCConfig.tpu({', '.join(args)})"
    return {
        "card": card, "config": label, "instances": n_instances,
        "scans": N_SCANS,
        "wall_ms_per_scan": walls,
        "device_kernel_ms_per_scan": dev_ms / N_SCANS,
        "kernel_launches_per_scan": n_launch / N_SCANS,
        "device_busy_share": busy_share(dev, t0),
        "top_kernels": [{"name": e.key[:80],
                         "ms_per_scan": e.self_device_time_total / 1e3
                         / N_SCANS,
                         "calls_per_scan": e.count / N_SCANS}
                        for e in top],
        "port_kernels": [{"name": e.key.split("::", 1)[1].split("(")[0],
                          "us_per_call": e.self_device_time_total / e.count,
                          "calls_per_scan": e.count / N_SCANS}
                         for e in own],
        "port_counts": counts,
        "counts_agree": all(r["agree"] for r in counts),
        "host_ms_by_span": host_ms_by_span(spans, N_SCANS),
        "idle_gaps": gaps,
        "idle_share_outside_spans": uncovered,
        "spans_dropped": tracing.dropped()}


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--belief-kernel", choices=("on", "off", "both"),
                    default="on")
    ap.add_argument("--select-kernel", choices=("on", "off", "both"),
                    default="off")
    ap.add_argument("--instances", type=int, default=1,
                    help="B > 1: the batched replay of B instances")
    args = ap.parse_args()
    if args.instances < 1:
        raise SystemExit("profile_replay: --instances must be >= 1")
    if not torch.cuda.is_available():
        raise SystemExit("profile_replay: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    modes = {"on": (True,), "off": (False,), "both": (True, False)}
    agree = True
    for bk in modes[args.belief_kernel]:
        for sk in modes[args.select_kernel]:
            res = profile(bk, card, args.instances, sk)
            print(json.dumps(res), flush=True)
            agree &= res["counts_agree"]
    if not agree:
        raise SystemExit("profile_replay: the profiler's kernel counts "
                         "differ from the port's launch counters")


if __name__ == "__main__":
    main()
