"""What a drive records in its window: one ``Call`` per entry call, and
host spans on the profiler's clock.

A call is timed from the moment its input is handed to the entry until
its poses are on the host: ``t_call`` (handed over), ``t_return`` (the
entry returned: everything is enqueued), ``t_host`` (the poses are on the
host). The window opens before its first call's set-up (a pass's
``init_state``) and closes at the ``t_host`` of the first call that ends
at or after the window's length. A traced run profiles a slice of calls
after the window has closed, so that no call the window times ran under
the profiler."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import NamedTuple

from . import stats


class Call(NamedTuple):
    t_call: int          # perf_counter ns
    t_return: int
    t_host: int
    n_scans: int
    pass_id: int
    first_scan: int      # index of its first scan in the pass


class Recorder:
    """Calls and host spans of one window, and of the traced slice after
    it."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.calls: list = []        # the window's calls
        self.slice_calls: list = []  # calls after the window (traced)
        self.spans: list = []        # (name, start_ns, end_ns), Unix ns
        self.t_open = None
        self.t_close = None
        self._unix = time.time_ns() - time.perf_counter_ns()

    def open(self) -> None:
        self.t_open = time.perf_counter_ns()

    @property
    def closed(self) -> bool:
        return self.t_close is not None

    def unix(self, t: int) -> int:
        return t + self._unix

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, self.unix(t0),
                               self.unix(time.perf_counter_ns())))

    def add(self, t_call: int, t_return: int, t_host: int, n_scans: int,
            pass_id: int, first_scan: int) -> bool:
        """Record a call and its spans; True once the window is over."""
        call = Call(t_call, t_return, t_host, n_scans, pass_id, first_scan)
        self.spans.append(("entry", self.unix(t_call), self.unix(t_return)))
        self.spans.append(("readback", self.unix(t_return),
                           self.unix(t_host)))
        if self.closed:
            self.slice_calls.append(call)
            return True
        self.calls.append(call)
        if (t_host - self.t_open) * 1e-9 >= self.seconds:
            self.t_close = t_host
            return True
        return False

    # ---- the end-to-end readings --------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t_close - self.t_open) * 1e-9

    @property
    def n_scans(self) -> int:
        return sum(c.n_scans for c in self.calls)

    def scans_per_s(self) -> float:
        return stats.rate(self.n_scans, self.window_s)

    def call_ms(self) -> list:
        """Each call's time from hand-over to poses on the host (ms)."""
        return [(c.t_host - c.t_call) * 1e-6 for c in self.calls]


def run(rec: Recorder, tracer, calls, slice_calls: int) -> None:
    """Drive a window: ``calls`` is a generator that makes one entry call
    a step and yields ``rec.add``'s answer. It runs until the window
    closes; with a tracer, ``slice_calls`` more calls are then profiled."""
    rec.open()
    try:
        for done in calls:
            if done:
                break
        if tracer is not None:
            tracer.start()
            for _ in range(slice_calls):
                next(calls)
            tracer.stop(sum(c.n_scans for c in rec.slice_calls), rec.spans)
    finally:
        calls.close()
