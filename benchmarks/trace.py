"""The traced slice after a window: ``torch.profiler`` over a few scans, read
from the profiler's raw device records, and the port's own launch counters
over the same scans.

``KERNEL_COUNTERS``, ``own_kernel``, ``reconcile`` and the trailer are
frozen copies of the port's ``profile_replay``: the profiler's launch count
of each hand-written kernel is held to the port's ``launches`` counters,
and a trailer of empty kernels after the slice takes any truncation of the
profiler's last records. Host spans are kept on the profiler's clock (Unix
nanoseconds), so that a gap in the device's activity can be named by what
the host was doing."""

from __future__ import annotations

import time
from typing import NamedTuple

# The port's hand-written kernels by their device symbol, each with the
# launch counters (module, key, device launches per count) that count it.
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
}
OWN_KERNELS = tuple(KERNEL_COUNTERS)
COUNTER_MODULES = {"assoc_kernels": "fl_slam_tpu_torch.ops.assoc_kernels",
                   "belief_kernels": "fl_slam_tpu_torch.ops.belief_kernels",
                   "surfel_kernels": "fl_slam_tpu_torch.ops.surfel_kernels",
                   "atlas_kernels":
                   "fl_slam_tpu_torch.structures.atlas_kernels"}
TRAILER = "spin_kernel"
TRAILER_LAUNCHES = 30000


def own_kernel(key: str):
    """The port kernel's symbol in a device record's name
    (``void (anonymous namespace)::moment_gather<float>(...)``), or None."""
    for k in OWN_KERNELS:
        if f"::{k}<" in key or f"::{k}(" in key or key == k:
            return k
    return None


def reconcile(events, counters: dict) -> list:
    """Hold the profiler's launches of each port kernel against the port's
    own counters over the same scans. ``events`` are (name, count) pairs
    of device kernels; ``counters`` maps a module name to its launch
    counts. One row per port kernel seen by either side."""
    seen = {}
    for key, count in events:
        k = own_kernel(key)
        if k is not None:
            seen[k] = seen.get(k, 0) + count
    rows = []
    for k, refs in KERNEL_COUNTERS.items():
        port = sum(counters.get(mod, {}).get(key, 0) * per
                   for mod, key, per in refs)
        prof = seen.get(k, 0)
        if port or prof:
            rows.append({"name": k, "profiler": prof, "port": port,
                         "agree": prof == port})
    return rows


def counter_snapshot() -> dict:
    """A copy of the port's ``launches`` counters, by module."""
    import importlib
    return {k: dict(importlib.import_module(m).launches)
            for k, m in COUNTER_MODULES.items()}


def counter_diff(before: dict, after: dict) -> dict:
    return {m: {k: after[m][k] - before[m].get(k, 0) for k in after[m]}
            for m in after}


class Slice(NamedTuple):
    """What the profiler saw over the traced scans."""

    scans: int
    kernels: list        # (name, start_ns, end_ns) device kernels
    device_ops: list     # (name, start_ns, end_ns) every device record
    dispatch_ns: int     # the slice's first host launch
    counters: dict       # the port's launches over the slice, by module
    reconcile: list      # profiler counts against the port's counters
    spans: list          # (name, start_ns, end_ns) host spans in the slice


def now_ns() -> int:
    """The profiler's clock: Unix time in nanoseconds."""
    return time.time_ns()


class Tracer:
    """Profiles one slice of a window: ``start()`` before its first call,
    ``stop(n_scans)`` after its last pose is on the host."""

    def __init__(self):
        self.slice = None
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._before = counter_snapshot()
        self._t0 = now_ns()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self, n_scans: int, spans: list) -> None:
        import torch
        torch.cuda.synchronize()
        after = counter_snapshot()
        for _ in range(TRAILER_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(0.2)
        self._prof.__exit__(None, None, None)
        records = self._prof.profiler.kineto_results.events()
        dev, launches = [], []
        for e in records:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                name = e.name()
                if TRAILER in name:
                    continue
                s = e.start_ns()
                dev.append((name, s, s + e.duration_ns()))
            elif e.name().startswith("cuda") and "Launch" in e.name():
                launches.append(e.start_ns())
        kernels = [d for d in dev if _is_kernel(d[0])]
        counts = {}
        for name, _, _ in kernels:
            counts[name] = counts.get(name, 0) + 1
        diff = counter_diff(self._before, after)
        self.slice = Slice(
            scans=n_scans, kernels=kernels, device_ops=dev,
            dispatch_ns=min(launches) if launches else self._t0,
            counters=diff, reconcile=reconcile(counts.items(), diff),
            spans=[s for s in spans if s[2] >= self._t0])
        self._prof = None


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))
