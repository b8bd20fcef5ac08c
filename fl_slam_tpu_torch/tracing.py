"""Host spans and counters of the port, on the profiler's clock.

The port's only span and counter recorder. It records only while a
``torch.profiler`` session is active (torch's own fast flag,
``torch.autograd.profiler._is_profiler_enabled``, which every profiling
session sets whatever its activities); otherwise a span site costs one
flag check and returns a shared null context, and nothing is allocated.

A span records its name, its id, its parent's id (-1 for a root), the
sequence number of the root call it belongs to (the request identifier:
one per ``pipeline.replay`` / ``pipeline.step`` call, one per staging
read), its thread's native id, and its start and end in Unix nanoseconds,
the clock of the profiler's raw records (``time.time_ns``), so that a
device record can be placed inside the host span that launched it.
Spans are kept in a bounded buffer (the oldest dropped first, and
counted); ``spans()`` / ``counters()`` return snapshots without draining
and ``reset()`` clears both.

Span names (the layer boundaries):
- ``pipeline.replay`` / ``pipeline.step``: the root of one ``replay`` /
  ``make_step`` call; ``pipeline.chunk_begin``, ``pipeline.scan_core``,
  ``pipeline.chunk_end``, ``pipeline.pack`` (the certificates and poses
  stacked) and ``pipeline.flush`` below it;
- ``scan.imu``, ``scan.deskew``, ``scan.predict``, ``scan.associate``,
  ``scan.visual``, ``scan.tail``, ``scan.map_update``: the numbered steps
  of one ``pipeline.scan_core`` (on a CUDA device only while its graph is
  captured: a graph replay runs no Python);
- ``io.read``, ``io.pack`` (the staging thread) and ``io.upload`` (the
  caller's thread) of ``io.rosbag.StreamingStager``.

The root ``replicas.replay`` of one instance-batched replay of a device's
instances (``parallel.replicas.batched_replay``), with the phase spans
above below it and ``replicas.pack`` / ``replicas.flush`` in place of
``pipeline.pack`` / ``pipeline.flush``.

Counters ``vmap.fallback`` and ``replicas.fallback``, keyed by operator:
``torch.func.vmap``'s per-instance fallbacks (an operator with no
batching rule) inside the hypothesis bank's ``vmap`` calls and inside the
instance ``vmap`` of the batched phases (``vmap_fallbacks``); a fallback
under both is counted by the innermost. Counters ``graph.replay`` and
``graph.capture``, keyed by phase (``chunk_begin``, ``scan_core``,
``chunk_end``), and ``graph.eager``, keyed by the reason a phase call
stayed eager (``cpu``, ``functorch``): the pipeline's phase calls
(``graphs``), the batched phases' among them, one count a call for all
its instances. A graph replay runs no Python, so ``graphs`` credits each
replay with the fallbacks its capture counted (``recording``).
"""

from __future__ import annotations

import itertools
import re
import threading
import time
import warnings
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 65536


class Span(NamedTuple):
    name: str
    id: int
    parent: int          # the enclosing span's id on this thread, -1: root
    root: int            # sequence number of the root call
    thread: int          # threading.get_native_id()
    start_ns: int        # Unix ns, the profiler's clock
    end_ns: int


_spans: deque = deque(maxlen=MAX_SPANS)
_dropped = 0
_counters: dict = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_roots = itertools.count(1)
_local = threading.local()
_NULL = nullcontext()


def enabled() -> bool:
    """Whether a ``torch.profiler`` session is recording."""
    return _profiler._is_profiler_enabled


def _open(name: str) -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        # the native id is a system call on some hosts: read it once
        stack, _local.thread = [], threading.get_native_id()
        _local.stack = stack
    if stack:
        parent, root = stack[-1][1], stack[-1][3]
    else:
        parent, root = -1, next(_roots)
    frame = [name, next(_ids), parent, root, time.time_ns()]
    stack.append(frame)
    return frame


def _close(frame: list) -> None:
    end = time.time_ns()
    stack = _local.stack
    # Children an exception left open are dropped with the frame above them.
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is frame:
            del stack[i:]
            break
    span = Span(frame[0], frame[1], frame[2], frame[3], _local.thread,
                frame[4], end)
    global _dropped
    with _lock:
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(span)


class _Span:
    __slots__ = ("name", "frame")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.frame = _open(self.name)

    def __exit__(self, *exc):
        _close(self.frame)


def span(name: str):
    """A context manager that records one span while tracing is on."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


class _Laps:
    """Consecutive sibling spans: ``lap(name)`` closes the open one and
    opens the next, ``close()`` closes the last."""

    __slots__ = ("frame",)

    def __init__(self, name: str):
        self.frame = _open(name)

    def __call__(self, name: str) -> None:
        _close(self.frame)
        self.frame = _open(name)

    def close(self) -> None:
        _close(self.frame)


class _NullLaps:
    __slots__ = ()

    def __call__(self, name: str) -> None:
        pass

    def close(self) -> None:
        pass


_NULL_LAPS = _NullLaps()


def laps(name: str):
    """A lap marker whose first span is ``name`` (see ``_Laps``); a shared
    no-op while tracing is off."""
    if not _profiler._is_profiler_enabled:
        return _NULL_LAPS
    return _Laps(name)


def count(name: str, key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` under ``key`` while tracing is on, and
    to every ``recording`` open on this thread whatever the profiler."""
    for rec in getattr(_local, "records", ()):
        rec[(name, key)] = rec.get((name, key), 0) + n
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        c = _counters.setdefault(name, {})
        c[key] = c.get(key, 0) + n


@contextmanager
def recording():
    """Yield a dict {(counter, key): n} of what ``count`` adds on this
    thread inside the block, with or without a profiler; the fallback
    counters (``vmap_fallbacks``) count inside it too."""
    rec: dict = {}
    records = getattr(_local, "records", None)
    if records is None:
        records = _local.records = []
    records.append(rec)
    try:
        yield rec
    finally:
        records.remove(rec)


_FALLBACK = re.compile(r"have not yet implemented the (?:nested )?batching "
                       r"rule for (\S+?)\.? Please")


def _fallback_warning_enabled() -> bool:
    """Whether functorch warns on a fallback. torch sets the flag and has
    no getter: read it from an in-place scatter of a batched tensor on the
    CPU, an operator with no batching rule."""
    def f(x):
        return x.clone().scatter_(0, torch.zeros(1, dtype=torch.long), x)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.func.vmap(f)(torch.zeros(1, 1))
    return any(_FALLBACK.search(str(w.message)) for w in caught)


@contextmanager
def _counting_fallbacks(name: str):
    prev = _fallback_warning_enabled()
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(prev)
    for w in caught:
        m = _FALLBACK.search(str(w.message))
        if m:
            count(name, m.group(1))
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno, source=w.source)


def vmap_fallbacks(name: str = "vmap.fallback"):
    """Around a ``torch.func.vmap`` call: while tracing is on or a
    ``recording`` is open, count its per-instance fallbacks under counter
    ``name`` by operator (the fallback warning is turned on and its flag
    restored after; other warnings pass through)."""
    if not (_profiler._is_profiler_enabled or getattr(_local, "records",
                                                      None)):
        return _NULL
    return _counting_fallbacks(name)


def spans() -> list:
    """The closed spans recorded so far, oldest first (a copy)."""
    with _lock:
        return list(_spans)


def counters() -> dict:
    """{name: {key: n}} (a copy)."""
    with _lock:
        return {k: dict(v) for k, v in _counters.items()}


def dropped() -> int:
    """Spans dropped from the full buffer since the last ``reset()``."""
    return _dropped


def reset() -> None:
    """Clear the spans, the counters and the drop count."""
    global _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0
