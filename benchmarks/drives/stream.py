"""A user replaying a bag: the traffic's bag is written in set-up under
``TMPDIR``; the window streams it with ``io.rosbag.StreamingStager`` (a
staging thread one segment ahead, two pinned buffers) through
``pipeline.replay_segments``, the poses read to the host after each
segment, and starts again with a fresh stager and state if the bag ends.
The segment bookkeeping is ``segments.Drive``'s.

Traffic keys: ``seg_len``. The cell's ``check.scans``: how many of the
window's first scans the check compares (a prefix, the reference stages
and replays every scan before the last one it compares)."""

from __future__ import annotations

import shutil
import tempfile
import time

from benchmarks import program
from benchmarks.drives import segments


class Drive(segments.Drive):
    def __init__(self, cell):
        super().__init__(cell)
        self.stager_wait_s = []
        self.dir = None

    def _stager(self, max_scans=None, seg_len=None):
        from fl_slam_tpu_torch.io.rosbag import BagTopics, StreamingStager
        return StreamingStager(
            self.bag, BagTopics(**self.cell.generator.KIMERA_TOPICS),
            self.cfg, seg_len or self.seg_len, max_scans=max_scans,
            device=self.cell.device)

    def _t0(self) -> float:
        from fl_slam_tpu_torch.io.rosbag import TIME_REBASE_MARGIN_S
        return TIME_REBASE_MARGIN_S - 0.1

    def setup(self) -> None:
        from fl_slam_tpu_torch import pipeline
        c = self.cell
        t0 = time.perf_counter()
        self.dir = tempfile.mkdtemp(prefix="gc_bench_bag_")
        self.bag = c.generator.write(c.traffic, self.dir, c.seed)
        t1 = time.perf_counter()
        R = max(1, int(self.cfg.view_refresh_every))
        st = pipeline.init_state(self.cfg, t0=self._t0(), device=c.device)
        stager = self._stager(max_scans=R, seg_len=R)
        _, out = pipeline.replay_segments(st, iter(stager), self.cfg,
                                          device=c.device)
        out.pose.cpu()
        program.sync(c.device)
        self.setup_split = {"traffic": t1 - t0,
                            "warm_up": time.perf_counter() - t1}

    def _calls(self, rec):
        from fl_slam_tpu_torch import pipeline
        T = int(self.cell.traffic["n_scans"])
        p = 0
        while True:
            with rec.span("stager_open"):
                stager = self._stager()
            with rec.span("init_state"):
                state = pipeline.init_state(self.cfg, t0=self._t0(),
                                            device=self.cell.device)
            segs = iter(stager)
            used = 0                    # segments the window consumed
            try:
                for a in range(0, T, self.seg_len):
                    with rec.span("stager_wait"):
                        seg = next(segs)
                    used += not rec.closed
                    state, done = self._call(rec, state, seg, p, a,
                                             min(self.seg_len, T - a))
                    yield done
            finally:
                segs.close()
                self.stager_wait_s.extend(stager.wait_s[:used])
            p += 1

    def compared(self):
        n0 = sum(o[2].shape[0] for o in self.outs if o[0] == 0)
        cap = int(self.cell.spec["check"].get("scans", n0))
        return [(0, min(n0, cap))]

    def reference(self, ref, precision: str, p: int, n: int):
        from benchmarks.reference import bag
        fields = bag.stage(self.bag, self.cell.generator.KIMERA_TOPICS,
                           self.cell.ref_cfg, n)
        return ref.replay_segments(self.cell.ref_cfg, fields, self.seg_len,
                                   bag.TIME_REBASE_MARGIN_S - 0.1, n,
                                   self.cell.device, precision=precision)

    def close(self) -> None:
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None
