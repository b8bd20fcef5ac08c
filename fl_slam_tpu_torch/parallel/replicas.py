"""Instance-batched replay: N independent SLAM instances (bags, noise seeds)
on one card or several (port of ``fl_slam_tpu/parallel/replicas.py``).

The instances share nothing, so each of the pipeline's three chunk phases
has a batched form, the phase under ``torch.func.vmap`` over the instance
axis of the state, the view context and the scan (``PHASES``): every
per-instance tensor carries a leading instance axis, the ops batch over
it, and each hand-written kernel's instance-batching rule launches one
kernel for all instances (K7: K1/K2, the exchange; K3, K4 and K6
batched). The batched replay and step run the pipeline's own chunk loop
(``pipeline._chunks`` / ``pipeline._step``) over these forms, outside any
``vmap``: on a CUDA device each batched phase is then the replay of one
CUDA graph for all the device's instances (``graphs``), on the CPU an
eager call. The reference's device mesh becomes a tuple of devices: the
instance axis is split into contiguous shards, one batched program per
device, with no communication. On one card the split is the identity.

State ownership is as in ``pipeline.replay``: a batched call consumes the
states it is given (the pools and slabs are updated in place), and on a
CUDA device the states it returns live in the graphs' static buffers,
which the next call of the same shapes on that device overwrites (where a
mesh names one device twice, each shard's result is copied out).

Tracing (``tracing``): the root span ``replicas.replay`` a device's
batched replay, ``replicas.pack`` / ``replicas.flush`` below it; counter
``replicas.fallback`` (the instance ``vmap``'s per-instance fallbacks, by
operator). A batched phase call counts as one ``graph.replay`` or
``graph.eager`` call for all its instances (``graphs``).
"""

from __future__ import annotations

import functools

import torch
import torch.utils._pytree as pytree

from fl_slam_tpu_torch import cuda_build, graphs, pipeline, tracing
from fl_slam_tpu_torch.certs import assert_memory_envelope
from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.pipeline import flush_slabs, init_state
from fl_slam_tpu_torch.runtime import resolve_device


def make_mesh(devices=None) -> tuple:
    """The devices the instance axis is split over: ``devices`` (e.g.
    ``["cpu"]``), or the current CUDA device (raises without one)."""
    if devices is None:
        return (resolve_device(None),)
    return tuple(resolve_device(d) for d in devices)


def stack_instances(trees):
    """Stack per-instance states or scan inputs on a new leading axis."""
    leaves, spec = zip(*(pytree.tree_flatten(t) for t in trees))
    return pytree.tree_unflatten(
        [torch.stack(xs) for xs in zip(*leaves)], spec[0])


def _bounds(n: int, n_dev: int):
    per = -(-n // n_dev)
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(n_dev)]


def shard_scan_inputs(scans, mesh):
    """Split stacked inputs (leading instance axis) into contiguous shards,
    one per device of ``mesh``, each moved to its device."""
    n = pytree.tree_leaves(scans)[0].shape[0]
    return tuple(pytree.tree_map(lambda a: a[i0:i1].to(dev), scans)
                 for (i0, i1), dev in zip(_bounds(n, len(mesh)), mesh))


def init_states_batched(cfg: GCConfig, n_instances: int, anchors0=None,
                        t0=0.0, mesh=None,
                        staged_bytes: int = 0) -> tuple:
    """Initial states of ``n_instances`` instances: one stacked
    ``PipelineState`` per device of ``mesh``, with contiguous shards of the
    instances. ``anchors0`` and ``t0`` are per instance (``t0`` may be one
    float for all).

    Fails fast, before allocating anything, when a device's share of the
    instances cannot fit its memory (``certs.assert_memory_envelope``)."""
    mesh = make_mesh() if mesh is None else mesh
    bounds = _bounds(n_instances, len(mesh))
    for (i0, i1), dev in zip(bounds, mesh):
        assert_memory_envelope(cfg, i1 - i0, device=dev,
                               staged_bytes=staged_bytes // len(mesh))
    t0s = [t0] * n_instances if isinstance(t0, (int, float)) else list(t0)
    shards = []
    for (i0, i1), dev in zip(bounds, mesh):
        # Each instance is written into the stacked state as it is made, so
        # that the shard never holds its states twice.
        stacked = spec = None
        for j, i in enumerate(range(i0, i1)):
            leaves, spec = pytree.tree_flatten(init_state(
                cfg, anchor0=None if anchors0 is None else anchors0[i],
                t0=float(t0s[i]), device=dev))
            if stacked is None:
                stacked = [x.new_empty((i1 - i0,) + x.shape) for x in leaves]
            for dst, x in zip(stacked, leaves):
                dst[j] = x
        shards.append(pytree.tree_unflatten(stacked, spec))
    return tuple(shards)


def _batched(fn, *args):
    """``fn(*args)`` under ``torch.func.vmap`` over the leading instance
    axis of every tensor of ``args``. The leaves that are not tensors (a
    view context's absent fields, in and out) are the same for every
    instance and pass through as they are."""
    kept = {}

    def tensors_out(*a):
        flat, kept["spec"] = pytree.tree_flatten(fn(*a))
        kept["flat"] = [_TENSOR if isinstance(x, torch.Tensor) else x
                        for x in flat]
        return [x for x in flat if isinstance(x, torch.Tensor)]

    in_dims = pytree.tree_map(
        lambda x: 0 if isinstance(x, torch.Tensor) else None, args)
    with tracing.vmap_fallbacks("replicas.fallback"):
        outs = iter(torch.func.vmap(tensors_out, in_dims=in_dims)(*args))
    return pytree.tree_unflatten([next(outs) if x is _TENSOR else x
                                  for x in kept["flat"]], kept["spec"])


_TENSOR = object()      # a tensor's place among an output's leaves


def _begin(state, cfg, *, gamma_power: int = 1):
    return _batched(functools.partial(pipeline._chunk_begin, cfg=cfg,
                                      gamma_power=gamma_power), state)


def _core(state, ctx, scan, cfg):
    return _batched(functools.partial(pipeline._scan_core, cfg=cfg), state,
                    ctx, scan)


def _end(state, ctx, cfg):
    return _batched(functools.partial(pipeline._chunk_end, cfg=cfg), state,
                    ctx)


# The batched phases, made once, so that a graph lineage keyed on them holds
# from call to call; each looks the pipeline's phase up at its call.
PHASES = graphs.Phases(_begin, _core, _end)


def _per_device(fn, *shards):
    """``fn`` on each device's shard (the device last among the arguments),
    with that device current, so that its kernels launch there. Where the
    mesh names a device with graphs twice, its shards share one graph
    lineage, so each of their results is copied out of the lineage's
    buffers."""
    out = []
    devs = [args[-1] for args in zip(*shards)]
    for args in zip(*shards):
        dev = args[-1]
        with cuda_build.device_guard(dev):
            r = fn(*args)
            if devs.count(dev) > 1 and graphs.eager_reason(dev) is None:
                r = pytree.tree_map(
                    lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, r)
        out.append(r)
    return tuple(out)


def _pairs(results):
    """((states, outputs) per device) -> (states per device, outputs per
    device)."""
    return tuple(map(tuple, zip(*results))) if results else ((), ())


def batched_step(cfg: GCConfig, mesh):
    """One scan for every instance, batched per device. Returns fn(states,
    scans) -> (states', outputs) over tuples of per-device shards (scans
    without a time axis).

    Like the single-instance carry, the returned states' pools are stale
    for the active tiles (the truth is in the resident slabs): reconcile
    with ``flush_states_batched`` before reading them."""

    def one(state, scan, dev):
        pipeline._on(dev, state.slabs.ff, scan.points)
        return pipeline._step(state, scan, cfg, dev, PHASES)

    def step(states, scans):
        return _pairs(_per_device(one, states, scans, mesh))

    return step


def batched_replay(cfg: GCConfig, mesh):
    """The chunked replay of every instance, batched per device. Returns
    fn(states, scans) -> (states', outputs) over tuples of per-device
    shards; scans carry (n, T, ...) per shard, outputs (n, T, ...). The
    returned pools are reconciled (the replay ends with the flush).

    The insert writes its target pages back whole (``insert_page_dense``,
    kernel K6), as the reference's batched replay does: under the instance
    batch that is one page gather and one page write-back launch per scan
    for all instances."""
    cfg = cfg.replace(insert_page_dense=True)

    def one(state, scans, dev):
        with tracing.span("replicas.replay"):
            pipeline._on(dev, state.slabs.ff, scans.points)
            state, outs = pipeline._chunks(state, scans, cfg, dev, PHASES,
                                           instances=True)
            with tracing.span("replicas.pack"):
                out = pipeline._stack_outputs(outs, cfg, dev, instances=True)
            with tracing.span("replicas.flush"):
                return flush_slabs(state, dev, instances=True), out

    def run(states, scans):
        return _pairs(_per_device(one, states, scans, mesh))

    return run


def flush_states_batched(states, mesh) -> tuple:
    """Reconcile every instance's pool with its resident slabs (required
    before reading the pools after ``batched_step`` loops)."""
    return _per_device(
        lambda s, dev: flush_slabs(s, dev, instances=True), states, mesh)
