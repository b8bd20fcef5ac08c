"""CUDA graphs of the pipeline's three chunk phases.

``pipeline.replay`` and ``pipeline.process_scan`` run a chunk as
``_chunk_begin``, R x ``_scan_core`` and ``_chunk_end``, and the
instance-batched replay (``parallel.replicas``) runs the same loop over
their ``vmap``-ed forms on a stacked state. Eagerly, each phase is a few
hundred to a few thousand launches from Python, and the card waits on
them. ``phases`` picks how the phases run from what it sees in its input:
on a CUDA device, outside any ``torch.func`` transform, each phase runs as
the replay of a captured ``torch.cuda.CUDAGraph`` (for all B instances at
once where the phases are the batched forms); on the CPU, and inside a
transform, the phases run eagerly. A capture that fails raises; nothing
falls back to the eager phases quietly.

A lineage is keyed by the configuration, the device and the structure,
dtype and shape of every leaf of the state and of one scan. Its graphs
(``_chunk_begin`` once per gamma power R, ``_scan_core``, ``_chunk_end``)
read and write one set of static buffers: the state, the chunk's view
context and the scan. The first call of a phase runs it eagerly (the
warm-up: ``runtime.const``'s uploads, the kernels' first-call attributes,
the allocator), writes its outputs into the buffers and then captures the
phase. A capture executes nothing, so no update is applied twice. Later
calls replay the graph. At most ``MAX_LINEAGES`` lineages are kept, the
least recently used dropped first.

Donation: a call returns the lineage's buffers as its state. A call whose
input leaves are those buffers copies nothing; any other input (a fresh
``init_state``, each scan) is copied in first. So the state a call returns
lives in buffers that the next call of the same lineage overwrites, also
when that call starts from another state. The tile pool and the resident
slabs are updated in place, as in the eager phases. Each scan's
``ScanOutput`` is packed into one buffer per dtype inside the graph and
returned as views of one copy, which no later replay writes.

Counters (``tracing``, recorded under the profiler only): ``graph.replay``
and ``graph.capture`` by phase, ``graph.eager`` by the reason a phase call
stayed eager (``cpu``, ``functorch``). A replay also advances the kernel
modules' ``launches`` counters by the counts its capture recorded (the
capture's own increments are taken back, as it launched nothing), so they
keep counting device launches, and the ``tracing`` counters by what the
capture counted (the ``vmap`` fallbacks of its Python), so they keep
counting what each call's Python would have met.
"""

from __future__ import annotations

from collections import OrderedDict
from contextlib import nullcontext
from typing import Callable, NamedTuple

import torch

from fl_slam_tpu_torch import tracing
from fl_slam_tpu_torch.ops import assoc_kernels, belief_kernels, surfel_kernels
from fl_slam_tpu_torch.structures import atlas_kernels

MAX_LINEAGES = 2       # each keeps a state's buffers (~0.47 GB an instance)
_LAUNCHES = (assoc_kernels.launches, belief_kernels.launches,
             surfel_kernels.launches, atlas_kernels.launches)


class Phases(NamedTuple):
    """The pipeline's phase functions: ``begin(state, cfg, gamma_power=R)
    -> (state, ctx)``, ``core(state, ctx, scan, cfg) -> (state, ctx,
    out)``, ``end(state, ctx, cfg) -> state``."""

    begin: Callable
    core: Callable
    end: Callable


def _flatten(tree, leaves: list):
    """Append ``tree``'s tensors to ``leaves`` in order; return a hashable
    signature of its structure: types, dict keys, each tensor's dtype and
    shape, and every other value as it is."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (tree.dtype, tree.shape)
    if isinstance(tree, tuple):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves))
                            for k, v in tree.items()))
    return (None, tree)


def _unflatten(sig, leaves):
    """The tree of signature ``sig`` with its tensors taken in order from
    the iterator ``leaves``."""
    kind, body = sig
    if isinstance(kind, torch.dtype):
        return next(leaves)
    if kind is None:
        return body
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in body}
    vals = [_unflatten(s, leaves) for s in body]
    return kind(*vals) if hasattr(kind, "_fields") else kind(vals)


def signature(tree):
    """``(signature, leaves)`` of a tree (see ``_flatten``)."""
    leaves: list = []
    return _flatten(tree, leaves), leaves


def _assign(dst: list, src: list) -> None:
    """``dst[i] <- src[i]`` where ``src[i]`` is not ``dst[i]`` already. A
    source that shares memory with a destination written here is copied
    aside first, so the order of the copies does not matter."""
    pairs = [(d, s) for d, s in zip(dst, src)
             if d.data_ptr() != s.data_ptr() or d.stride() != s.stride()]
    if not pairs:
        return
    written = {d.untyped_storage().data_ptr() for d, _ in pairs}
    torch._foreach_copy_(
        [d for d, _ in pairs],
        [s.clone() if s.untyped_storage().data_ptr() in written else s
         for _, s in pairs])


class _Packing:
    """How a ``ScanOutput``'s tensors ride in one flat buffer per dtype:
    the 0-d ones first (they come back as one ``unbind``), then the rest."""

    def __init__(self, out):
        self.sig, leaves = signature(out)
        by_dtype: dict = {}
        for i, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, ([], []))[t.dim() > 0].append(i)
        self.groups = [(s, o, [leaves[i].shape for i in o])
                       for s, o in by_dtype.values()]
        self.n = len(leaves)

    def pack(self, out) -> list:
        leaves = signature(out)[1]
        return [torch.cat([leaves[i].reshape(1) for i in s]
                          + [leaves[i].reshape(-1) for i in o])
                for s, o, _ in self.groups]

    def unpack(self, bufs: list):
        leaves = [None] * self.n
        for (s, o, shapes), buf in zip(self.groups, bufs):
            parts = buf.split([len(s)] + [sh.numel() for sh in shapes])
            for i, v in zip(s, parts[0].unbind()):
                leaves[i] = v
            for i, sh, v in zip(o, shapes, parts[1:]):
                leaves[i] = v.view(sh)
        return _unflatten(self.sig, iter(leaves))


class _Graph(NamedTuple):
    graph: object          # torch.cuda.CUDAGraph
    outs: tuple            # the captured output buffers (the scan output)
    launched: tuple        # (launches dict, key, count) the capture counted
    counted: tuple = ()    # ((counter, key), n): tracing counts of the capture


def _launch_counts() -> list:
    return [dict(d) for d in _LAUNCHES]


def _capture(lineage, body) -> _Graph:
    """Capture ``body()`` (which returns its output buffers, or None) into
    a graph in the lineage's memory pool. The capture refuses unsafe CUDA
    calls on this thread only: a bag stager's thread may meanwhile pin a
    host buffer or query an event."""
    if lineage.pool is None:
        lineage.pool = torch.cuda.graph_pool_handle()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, pool=lineage.pool,
                          capture_error_mode="thread_local"):
        outs = body()
    return _Graph(g, tuple(outs or ()), ())


class _Lineage:
    """The static buffers of one key and the graphs that read and write
    them (see the module docstring)."""

    def __init__(self, key, fns: Phases, cfg, dev, state_sig, scan_sig,
                 state, scan):
        self.key, self.fns, self.cfg, self.dev = key, fns, cfg, dev
        self.state_sig, self.scan_sig = state_sig, scan_sig
        self.S = [torch.empty_like(t) for t in state]
        self.X = [torch.empty_like(t) for t in scan]
        self.state = _unflatten(state_sig, iter(self.S))
        self.scan = _unflatten(scan_sig, iter(self.X))
        self.ctx_sig = self.C = self.ctx = None
        self.packing = None
        self.graphs: dict = {}
        self.pool = None

    # ---- the buffers ------------------------------------------------------
    def _take(self, state, ctx=None) -> None:
        """Copy a state (and context) that are not the buffers into them;
        the key has matched their structure."""
        if state is not self.state:
            _assign(self.S, signature(state)[1])
        if ctx is not None and ctx is not self.ctx:
            _assign(self.C, signature(ctx)[1])

    def _store(self, state, ctx=None) -> None:
        """Write a phase's outputs into the buffers (eagerly at the
        warm-up, as graph nodes in the capture), state and context in one
        assignment: an output may be a buffer that another output
        overwrites."""
        sig, leaves = signature(state)
        if sig != self.state_sig:
            raise RuntimeError("graphs: a phase changed the state's "
                               "structure, dtypes or shapes")
        if ctx is None:
            _assign(self.S, leaves)
            return
        csig, cleaves = signature(ctx)
        if self.C is None:
            self.ctx_sig = csig
            self.C = [torch.empty_like(t) for t in cleaves]
            self.ctx = _unflatten(csig, iter(self.C))
        elif csig != self.ctx_sig:
            raise RuntimeError("graphs: a phase changed the view context's "
                               "structure, dtypes or shapes")
        _assign(self.S + self.C, leaves + cleaves)

    # ---- one phase ----------------------------------------------------------
    def _run(self, key, phase: str, body):
        """Replay the phase's graph; at its first call run ``body`` eagerly
        (the warm-up) and then capture it. Returns the output buffers of
        this call (copies of the graph's, which the next replay writes)."""
        with _guard(self.dev):
            g = self.graphs.get(key)
            if g is not None:
                g.graph.replay()
                for counts, k, n in g.launched:
                    counts[k] += n
                for (name, k), n in g.counted:
                    tracing.count(name, k, n)
                tracing.count("graph.replay", phase)
                return [b.clone() for b in g.outs]
            outs = body()
            before = _launch_counts()
            with tracing.recording() as counted:
                g = _capture(self, body)
            launched = []
            for counts, was in zip(_LAUNCHES, before):
                for k in counts:
                    n = counts[k] - was.get(k, 0)
                    if n:
                        launched.append((counts, k, n))
                counts.clear()
                counts.update(was)
            self.graphs[key] = g._replace(launched=tuple(launched),
                                          counted=tuple(counted.items()))
            tracing.count("graph.capture", phase)
            return outs

    def begin(self, state, gamma_power: int):
        self._take(state)

        def body():
            self._store(*self.fns.begin(self.state, self.cfg,
                                        gamma_power=gamma_power))

        self._run(("chunk_begin", gamma_power), "chunk_begin", body)
        return self.state, self.ctx

    def core(self, state, ctx, scan):
        self._take(state, ctx)
        _assign(self.X, signature(scan)[1])

        def body():
            st, cx, out = self.fns.core(self.state, self.ctx, self.scan,
                                        self.cfg)
            if self.packing is None:
                self.packing = _Packing(out)
            bufs = self.packing.pack(out)   # before the buffers it may read
            self._store(st, cx)             # are overwritten
            return bufs

        bufs = self._run("scan_core", "scan_core", body)
        return self.state, self.ctx, self.packing.unpack(bufs)

    def end(self, state, ctx):
        self._take(state, ctx)

        def body():
            self._store(self.fns.end(self.state, self.ctx, self.cfg))

        self._run("chunk_end", "chunk_end", body)
        return self.state


class _Eager:
    """The phases as plain calls, each counted under ``graph.eager`` with
    the reason it stayed eager."""

    def __init__(self, fns: Phases, cfg, reason: str):
        self.fns, self.cfg, self.reason = fns, cfg, reason

    def begin(self, state, gamma_power: int):
        tracing.count("graph.eager", self.reason)
        return self.fns.begin(state, self.cfg, gamma_power=gamma_power)

    def core(self, state, ctx, scan):
        tracing.count("graph.eager", self.reason)
        return self.fns.core(state, ctx, scan, self.cfg)

    def end(self, state, ctx):
        tracing.count("graph.eager", self.reason)
        return self.fns.end(state, ctx, self.cfg)


def _guard(dev):
    """``dev`` as the current CUDA device, where it is not already (a
    graph captures and replays on the current device's stream)."""
    if dev.type != "cuda" or dev.index == torch.cuda.current_device():
        return _NULL
    return torch.cuda.device(dev)


_NULL = nullcontext()
_lineages: OrderedDict = OrderedDict()


def eager_reason(dev: torch.device):
    """Why the phases on ``dev`` stay eager (``functorch``: inside a
    ``torch.func`` transform, where the inputs are not real tensors;
    ``cpu``: not a CUDA device), or None where they run as graphs."""
    if torch._C._functorch.maybe_current_level() is not None:
        return "functorch"
    if dev.type != "cuda":
        return "cpu"
    return None


def phases(fns: Phases, state, scan, cfg, dev: torch.device):
    """The runner of the phases for this input, with ``begin(state, R)``,
    ``core(state, ctx, scan)`` and ``end(state, ctx)``: the graphs of the
    input's lineage (made at its first use), or the eager phases where
    ``eager_reason`` gives a reason. ``scan`` is one scan of the call."""
    reason = eager_reason(dev)
    if reason is not None:
        return _Eager(fns, cfg, reason)
    scan_sig, scan_leaves = signature(scan)
    for lin in _lineages.values():
        # The common case: the state is the one a lineage returned.
        if (lin.state is state and lin.cfg is cfg and lin.dev == dev
                and lin.fns == fns and lin.scan_sig == scan_sig):
            _lineages.move_to_end(lin.key)
            return lin
    state_sig, state_leaves = signature(state)
    key = (fns, cfg, dev, state_sig, scan_sig)
    lin = _lineages.get(key)
    if lin is None:
        lin = _Lineage(key, fns, cfg, dev, state_sig, scan_sig,
                       state_leaves, scan_leaves)
        _lineages[key] = lin
        while len(_lineages) > MAX_LINEAGES:
            _lineages.popitem(last=False)
    _lineages.move_to_end(key)
    return lin


def clear() -> None:
    """Drop every lineage, its graphs and its buffers."""
    _lineages.clear()
