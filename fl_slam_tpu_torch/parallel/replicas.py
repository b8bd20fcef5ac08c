"""Instance-batched replay: N independent SLAM instances (bags, noise seeds)
on one card or several (port of ``fl_slam_tpu/parallel/replicas.py``).

The instances share nothing, so the batched program is the single-instance
one under ``torch.func.vmap``: every per-instance tensor carries a leading
instance axis, the ops batch over it, and each hand-written kernel's
instance-batching rule launches one kernel for all instances (K7: K1/K2,
the exchange; K3, K4 and K6 batched). The reference's device mesh becomes
a tuple of devices: the instance axis is split into contiguous shards, one
vmapped program per device, with no communication. On one card the split
is the identity.

State ownership is as in ``pipeline.replay``: a batched replay consumes the
states it is given (the pools and slabs are updated in place).
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from fl_slam_tpu_torch import cuda_build
from fl_slam_tpu_torch.certs import assert_memory_envelope
from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.pipeline import (flush_slabs, init_state,
                                        process_scan, replay)
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
        shards.append(stack_instances([init_state(
            cfg, anchor0=None if anchors0 is None else anchors0[i],
            t0=float(t0s[i]), device=dev) for i in range(i0, i1)]))
    return tuple(shards)


def _per_device(fn, *shards):
    """``fn`` on each device's shard (the device last among the arguments),
    with that device current, so that its kernels launch there."""
    out = []
    for args in zip(*shards):
        with cuda_build.device_guard(args[-1]):
            out.append(fn(*args))
    return tuple(out)


def _pairs(results):
    """((states, outputs) per device) -> (states per device, outputs per
    device)."""
    return tuple(map(tuple, zip(*results))) if results else ((), ())


def batched_step(cfg: GCConfig, mesh):
    """One scan for every instance, vmapped per device. Returns fn(states,
    scans) -> (states', outputs) over tuples of per-device shards (scans
    without a time axis).

    Like the single-instance carry, the returned states' pools are stale
    for the active tiles (the truth is in the resident slabs): reconcile
    with ``flush_states_batched`` before reading them."""

    def step(states, scans):
        return _pairs(_per_device(
            lambda s, sc, dev: torch.func.vmap(
                lambda a, b: process_scan(a, b, cfg, device=dev))(s, sc),
            states, scans, mesh))

    return step


def batched_replay(cfg: GCConfig, mesh):
    """The chunked replay of every instance, vmapped per device. Returns
    fn(states, scans) -> (states', outputs) over tuples of per-device
    shards; scans carry (n, T, ...) per shard. The returned pools are
    reconciled (``replay`` ends with ``flush_slabs``).

    The insert writes its target pages back whole (``insert_page_dense``,
    kernel K6), as the reference's batched replay does: under the instance
    batch that is one page gather and one page write-back launch per scan
    for all instances."""
    cfg = cfg.replace(insert_page_dense=True)

    def run(states, scans):
        return _pairs(_per_device(
            lambda s, sc, dev: torch.func.vmap(
                lambda a, b: replay(a, b, cfg, device=dev))(s, sc),
            states, scans, mesh))

    return run


def flush_states_batched(states, mesh) -> tuple:
    """Reconcile every instance's pool with its resident slabs (required
    before reading the pools after ``batched_step`` loops)."""
    return _per_device(
        lambda s, dev: torch.func.vmap(
            lambda a: flush_slabs(a, device=dev))(s), states, mesh)
