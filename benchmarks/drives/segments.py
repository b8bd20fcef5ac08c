"""An evaluation sweep: sequences staged on the device in set-up, replayed
back to back through ``pipeline.replay_segments`` in segments, the poses
read to the host after each segment.

The window cycles through the traffic's passes, each from a fresh
``init_state``. Traffic keys: ``seg_len`` (scans a segment, a multiple of
the configuration's chunk). The cell's ``check.passes``: how many of the
window's whole passes the check compares, drawn from the seed.

``Drive`` also holds the segment bookkeeping that other segment drives
reuse: one call and its record (``_call``), the window's outputs, and a
pass's outputs for the check. Such a drive supplies ``setup``, the
generator of its calls (``_calls``), ``compared`` and ``reference``."""

from __future__ import annotations

import random
import time

import numpy as np

from benchmarks import program, window


class Drive:
    slice_calls = 1             # the traced slice: one segment

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.cfg
        self.seg_len = int(cell.traffic["seg_len"])
        self.outs = []          # (pass, first scan, poses (n, 6), certs)

    def setup(self) -> None:
        from fl_slam_tpu_torch import pipeline
        c = self.cell
        t0 = time.perf_counter()
        self.data = c.generator.passes(c.traffic, program.sizes(self.cfg),
                                       c.seed)
        t1 = time.perf_counter()
        self.scans = [program.stage(d.scans, self.cfg, c.device)
                      for d in self.data]
        program.sync(c.device)
        t2 = time.perf_counter()
        self.t0s = [float(d.gt_stamps[0]) - 0.1 for d in self.data]
        R = max(1, int(self.cfg.view_refresh_every))
        st = pipeline.init_state(self.cfg, t0=self.t0s[0], device=c.device)
        warm = pipeline.ScanInput(*[f[:R] for f in self.scans[0]])
        _, out = pipeline.replay_segments(st, [warm], self.cfg,
                                          device=c.device)
        out.pose.cpu()
        program.sync(c.device)
        self.setup_split = {"traffic": t1 - t0, "staging": t2 - t1,
                            "warm_up": time.perf_counter() - t2}

    def window(self, rec, tracer) -> None:
        window.run(rec, tracer, self._calls(rec), self.slice_calls)

    def _calls(self, rec):
        from fl_slam_tpu_torch import pipeline
        p = 0
        while True:
            i = p % len(self.scans)
            scans = self.scans[i]
            T = int(scans.scan_start.shape[0])
            with rec.span("init_state"):
                state = pipeline.init_state(self.cfg, t0=self.t0s[i],
                                            device=self.cell.device)
            for a in range(0, T, self.seg_len):
                seg = pipeline.ScanInput(*[f[a:a + self.seg_len]
                                           for f in scans])
                state, done = self._call(rec, state, seg, p, a,
                                         min(self.seg_len, T - a))
                yield done
            p += 1

    def _call(self, rec, state, seg, p: int, a: int, n: int):
        """Replay one segment of ``n`` scans (the first ``n`` of a padded
        one), read its poses to the host and record the call; the
        window's outputs are kept for the check."""
        from fl_slam_tpu_torch import pipeline
        t_call = time.perf_counter_ns()
        state, out = pipeline.replay_segments(state, [seg], self.cfg,
                                              device=self.cell.device)
        t_ret = time.perf_counter_ns()
        poses = out.pose.cpu().numpy()[:n]
        t_host = time.perf_counter_ns()
        if not rec.closed:
            self.outs.append((p, a, poses,
                              {k: v[:n] for k, v in out.certs.items()}))
        return state, rec.add(t_call, t_ret, t_host, n, p, a)

    def outputs(self):
        """(poses (n, 6), certs {name: (n,)}) of every scan of the window."""
        poses = np.concatenate([o[2] for o in self.outs])
        certs = program.segment_cert_table([o[3] for o in self.outs])
        return poses, certs

    def release(self) -> None:
        self.outs = [(p, a, poses, {k: v.cpu() for k, v in c.items()})
                     for p, a, poses, c in self.outs]
        self.scans = None

    def compared(self):
        """The passes the check compares: drawn from the seed among the
        window's whole passes (the first pass when none is whole)."""
        n_per = {}
        for p, a, poses, _ in self.outs:
            n_per[p] = n_per.get(p, 0) + poses.shape[0]
        T = int(self.cell.traffic["n_scans"])
        whole = sorted(p for p, n in n_per.items() if n == T)
        k = int(self.cell.spec["check"].get("passes", 1))
        if not whole:
            return [(0, n_per[0])]
        rng = random.Random(self.cell.seed)
        return [(p, T) for p in sorted(rng.sample(whole, min(k, len(whole))))]

    def program_pass(self, p: int, n: int):
        rows = [o for o in self.outs if o[0] == p]
        poses = np.concatenate([o[2] for o in rows])[:n]
        certs = program.segment_cert_table([o[3] for o in rows])
        return poses, {k: v[:n] for k, v in certs.items()}

    def reference(self, ref, precision: str, p: int, n: int):
        d = self.data[p % len(self.data)]
        return ref.replay_segments(
            self.cell.ref_cfg, d.scans, self.seg_len, self.t0s[p % len(
                self.data)], n, self.cell.device, precision=precision)
