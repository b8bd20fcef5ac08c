"""Several robots' back ends on one card: B independent sequences staged
on the device in set-up, stacked on an instance axis, and replayed in
lockstep through ``parallel.replicas.batched_replay`` in segments, every
instance's poses read to the host after each segment.

B is the configuration file's ``robots_per_card`` (a traffic's
``instances`` overrides it, for the benchmark's own tests at small
sizes); instance b's sequence is the generator's with seed ``seed + b``.
The window replays the sequences again and again, each pass from fresh
states. A call records B x its segment's scans: a scan in this drive's
metrics is one instance's scan.

The check compares (pass, instance) pairs: every instance over the first
pass's first segment, and one instance drawn from the seed over a whole
pass drawn from the seed, each against the plain reference's replay of
that instance's sequence alone (``benchmarks/reference/replicas.py``)."""

from __future__ import annotations

import random
import time

import numpy as np

from benchmarks import harness, program
from benchmarks.drives import segments


class Drive(segments.Drive):
    slice_calls = 1             # the traced slice: one batched segment

    def __init__(self, cell):
        super().__init__(cell)
        conf = harness.load_json(harness.HERE / "configs"
                                 / f"{cell.spec['config']}.json")
        self.B = int(cell.traffic.get("instances", conf["robots_per_card"]))
        # (pass, first scan, poses (B, n, 6), certs {name: (B, n)})
        self.outs = []

    def setup(self) -> None:
        from fl_slam_tpu_torch.parallel import replicas
        c = self.cell
        t0 = time.perf_counter()
        self.data = c.generator.passes(dict(c.traffic, passes=self.B),
                                       program.sizes(self.cfg), c.seed)
        t1 = time.perf_counter()
        self.mesh = replicas.make_mesh([c.device])
        self.scans = replicas.shard_scan_inputs(replicas.stack_instances(
            [program.stage(d.scans, self.cfg, c.device)
             for d in self.data]), self.mesh)
        program.sync(c.device)
        t2 = time.perf_counter()
        self.t0s = [float(d.gt_stamps[0]) - 0.1 for d in self.data]
        self.run = replicas.batched_replay(self.cfg, self.mesh)
        R = max(1, int(self.cfg.view_refresh_every))
        _, (out,) = self.run(self._fresh(), self._segment(0, R))
        out.pose.cpu()
        program.sync(c.device)
        self.setup_split = {"traffic": t1 - t0, "staging": t2 - t1,
                            "warm_up": time.perf_counter() - t2}

    def _fresh(self):
        from fl_slam_tpu_torch.parallel import replicas
        return replicas.init_states_batched(self.cfg, self.B, t0=self.t0s,
                                            mesh=self.mesh)

    def _segment(self, a: int, n: int) -> tuple:
        """Scans a .. a + n of every instance, per device."""
        return tuple(type(s)(*[f[:, a:a + n] for f in s])
                     for s in self.scans)

    def _calls(self, rec):
        T = int(self.scans[0].scan_start.shape[1])
        p = 0
        while True:
            with rec.span("init_state"):
                states = self._fresh()
            for a in range(0, T, self.seg_len):
                states, done = self._call(rec, states,
                                          self._segment(a, self.seg_len), p,
                                          a, min(self.seg_len, T - a))
                yield done
            p += 1

    def _call(self, rec, states, seg, p: int, a: int, n: int):
        """One batched replay of a segment of every instance; the poses of
        all B read to the host; B x ``n`` scans recorded."""
        t_call = time.perf_counter_ns()
        states, (out,) = self.run(states, seg)
        t_ret = time.perf_counter_ns()
        poses = out.pose.cpu().numpy()[:, :n]
        t_host = time.perf_counter_ns()
        if not rec.closed:
            self.outs.append((p, a, poses,
                              {k: v[:, :n] for k, v in out.certs.items()}))
        return states, rec.add(t_call, t_ret, t_host, self.B * n, p, a)

    def outputs(self):
        """(poses (n, 6), certs {name: (n,)}) of every instance-scan of
        the window."""
        poses = np.concatenate([o[2].reshape(-1, 6) for o in self.outs])
        certs = program.segment_cert_table(
            [{k: v.reshape(-1) for k, v in o[3].items()} for o in self.outs])
        return poses, certs

    def release(self) -> None:
        super().release()
        self.run = None

    def compared(self):
        """(pass, instance) pairs: every instance over the first
        segment of pass 0; one instance drawn from the seed over a whole
        pass drawn from the seed (where the window holds one)."""
        n_per = {}
        for p, a, poses, _ in self.outs:
            n_per[p] = n_per.get(p, 0) + poses.shape[1]
        T = int(self.cell.traffic["n_scans"])
        whole = sorted(p for p, n in n_per.items() if n == T)
        rng = random.Random(self.cell.seed)
        b = rng.randrange(self.B)
        head = min(self.seg_len, n_per[0])
        pairs = [((0, i), head) for i in range(self.B)
                 if i != b or not whole]
        if whole:
            pairs.append(((rng.choice(whole), b), T))
        return pairs

    def program_pass(self, key, n: int):
        p, i = key
        rows = [o for o in self.outs if o[0] == p]
        poses = np.concatenate([o[2][i] for o in rows])[:n]
        certs = program.segment_cert_table(
            [{k: v[i] for k, v in o[3].items()} for o in rows])
        return poses, {k: v[:n] for k, v in certs.items()}

    def reference(self, ref, precision: str, key, n: int):
        from benchmarks.reference import replicas
        _, i = key
        return replicas.replay_instance(self.cell.ref_cfg,
                                        self.data[i].scans, self.seg_len,
                                        self.t0s[i], n, self.cell.device,
                                        precision=precision)
