"""A robot's closed loop: one scan handed to ``pipeline.make_step`` a
call, its pose read to the host before the next scan is handed over.

The sequence is staged on the device in set-up; the window runs it from a
fresh ``init_state`` and starts again from a fresh state if it ends.
The cell's ``check.scans``: how many of the window's first scans the
check compares (a prefix, as the reference must replay every scan before
the last one it compares)."""

from __future__ import annotations

import time

import numpy as np

from benchmarks import program, window


class Drive:
    slice_calls = 20            # the traced slice: 20 scans

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.cfg
        self.outs = []          # (pass, scan, pose (1, 6), certs)

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
        self.step = pipeline.make_step(self.cfg, device=c.device)
        st = pipeline.init_state(self.cfg, t0=self.t0s[0], device=c.device)
        _, out = self.step(st, pipeline.ScanInput(*[f[0]
                                                    for f in self.scans[0]]))
        out.pose.cpu()
        program.sync(c.device)
        self.setup_split = {"traffic": t1 - t0, "staging": t2 - t1,
                            "warm_up": time.perf_counter() - t2}

    def window(self, rec, tracer) -> None:
        window.run(rec, tracer, self._calls(rec), self.slice_calls)

    def _calls(self, rec):
        from fl_slam_tpu_torch import pipeline
        dev = self.cell.device
        p = 0
        while True:
            scans = self.scans[p % len(self.scans)]
            T = int(scans.scan_start.shape[0])
            with rec.span("init_state"):
                state = pipeline.init_state(
                    self.cfg, t0=self.t0s[p % len(self.scans)], device=dev)
            for i in range(T):
                scan = pipeline.ScanInput(*[f[i] for f in scans])
                t_call = time.perf_counter_ns()
                state, out = self.step(state, scan)
                t_ret = time.perf_counter_ns()
                pose = out.pose.cpu().numpy()[None]
                t_host = time.perf_counter_ns()
                if not rec.closed:
                    self.outs.append((p, i, pose, out.certs))
                yield rec.add(t_call, t_ret, t_host, 1, p, i)
            p += 1

    def outputs(self):
        poses = np.concatenate([o[2] for o in self.outs])
        certs = program.step_cert_table([o[3] for o in self.outs])
        return poses, certs

    def release(self) -> None:
        self.outs = [(p, i, pose, {k: v.cpu() for k, v in c.items()})
                     for p, i, pose, c in self.outs]
        self.scans = None
        self.step = None

    def compared(self):
        n0 = sum(1 for o in self.outs if o[0] == 0)
        cap = int(self.cell.spec["check"].get("scans", n0))
        return [(0, min(n0, cap))]

    def program_pass(self, p: int, n: int):
        rows = [o for o in self.outs if o[0] == p][:n]
        poses = np.concatenate([o[2] for o in rows])
        return poses, program.step_cert_table([o[3] for o in rows])

    def reference(self, ref, precision: str, p: int, n: int):
        d = self.data[p % len(self.data)]
        return ref.replay_steps(self.cell.ref_cfg, d.scans,
                                self.t0s[p % len(self.data)], n,
                                self.cell.device, precision=precision)
