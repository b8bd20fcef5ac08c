"""The port's twins of the repository root's ``__graft_entry__.py``: one
forward scan step at a tiny configuration, and the multi-device dry run.

``entry(device=None)`` returns ``(fn, (state, scan))``: ``fn(state, scan)``
runs the full per-scan update (``pipeline.process_scan``) and returns the
published pose.

``dryrun_multichip(n, devices=None)`` runs the reference's four checks
(``__graft_entry__.py:116-209``) on ``n`` instances split over ``devices``
(default: the first ``n`` visible cards; raises if there are fewer): (a) one
batched step, (b) a batched replay of 2 chunks of R = 3 scans, (c) every
instance of it within 1e-5 of the single-instance replay, (d) the memory
envelope of ``GCConfig.tpu()``. The reference re-executes itself in a
hermetic CPU subprocess to escape JAX's process-wide backend state; torch
has none, so the checks run in this process. A device may repeat
(``["cpu", "cpu"]``, or one card twice): each shard is then its own
vmapped program on that device.
"""

from __future__ import annotations

import numpy as np

# The H100's nominal 80 GB: the envelope's limit where the dry run's device
# has no memory to query (the CPU).
H100_HBM_BYTES = 80 * 10**9

# (c): each instance of the batched replay against the single-instance one.
INSTANCE_TOL = 1e-5


def _tiny_cfg():
    """The reference's ``_tiny_cfg`` (``__graft_entry__.py:18-36``)."""
    from fl_slam_tpu_torch.config import GCConfig
    return GCConfig.small(
        dtype="float32", n_points=128, imu_len=32, n_feat=8, n_surfel=32,
        m_tile=64, n_tiles_pool=16, m_tile_view=32, merge_max_tile=64,
        k_insert=8, surfel_cells_1=8, surfel_cells_2=8, surfel_cells_z=4,
        k_sinkhorn=5, view_page=32)


def _example_scans(cfg, device, n_instances=None):
    """Scans of ``simulate(seed=0)``: the first one, or one per instance
    (leading instance axis)."""
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.pipeline import ScanInput
    ds = simulate(cfg, n_scans=max(2, n_instances or 1), seed=0)
    scans = to_scan_inputs(ds, cfg, device=device)
    if n_instances is None:
        return ScanInput(*[f[0] for f in scans])
    return ScanInput(*[f[:n_instances] for f in scans])


def entry(device=None):
    """(fn, example_args): one forward scan step at the tiny configuration
    on ``device`` (default: the card; raises without one)."""
    from fl_slam_tpu_torch.pipeline import init_state, process_scan
    from fl_slam_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    cfg = _tiny_cfg()
    state = init_state(cfg, device=dev)
    scan = _example_scans(cfg, dev)

    def fn(state, scan):
        return process_scan(state, scan, cfg, device=dev)[1].pose

    return fn, (state, scan)


def _devices(n: int, devices):
    import torch
    if devices is None:
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"dryrun_multichip: need {n} CUDA devices, "
                               f"have {have}")
        devices = [f"cuda:{i}" for i in range(n)]
    if len(devices) != n:
        raise ValueError(f"dryrun_multichip: {len(devices)} devices for "
                         f"{n} shards")
    return devices


def _cat_poses(outs) -> np.ndarray:
    return np.concatenate([o.pose.cpu().numpy() for o in outs])


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The reference's dry run on ``n_devices`` shards of one instance each.
    Raises on a failed check; returns the checks' numbers."""
    import torch

    from fl_slam_tpu_torch.certs import (assert_memory_envelope,
                                         device_hbm_bytes, memory_envelope)
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.parallel import replicas
    from fl_slam_tpu_torch.pipeline import init_state, replay

    n = int(n_devices)
    mesh = replicas.make_mesh(_devices(n, devices))
    cfg = _tiny_cfg().replace(view_refresh_every=3)
    T = 2 * cfg.view_refresh_every      # two chunk boundaries

    # (a) one batched step over the mesh
    states = replicas.init_states_batched(cfg, n, mesh=mesh)
    scans1 = replicas.shard_scan_inputs(
        _example_scans(cfg, "cpu", n_instances=n), mesh)
    new_states, outs = replicas.batched_step(cfg, mesh)(states, scans1)
    poses = _cat_poses(outs)
    if poses.shape != (n, 6) or not np.isfinite(poses).all():
        raise AssertionError(f"batched step: poses {poses.shape}, finite "
                             f"{np.isfinite(poses).all()}")
    if min(int(s.scan_seq.min()) for s in new_states) != 1:
        raise AssertionError("batched step: scan_seq did not advance")

    # (b) a batched replay over 2 chunks, the carries consumed
    ds = simulate(cfg, n_scans=T, seed=7)
    seq = to_scan_inputs(ds, cfg, device="cpu")
    t0 = float(ds.gt_stamps[0]) - 0.1
    scansT = replicas.shard_scan_inputs(
        replicas.stack_instances([seq] * n), mesh)
    states = replicas.init_states_batched(cfg, n, t0=t0, mesh=mesh)
    final, routs = replicas.batched_replay(cfg, mesh)(states, scansT)
    bposes = np.concatenate([o.pose.cpu().numpy() for o in routs])
    if bposes.shape != (n, T, 6) or not np.isfinite(bposes).all():
        raise AssertionError(f"batched replay: poses {bposes.shape}, finite "
                             f"{np.isfinite(bposes).all()}")
    if min(int(s.scan_seq.min()) for s in final) != T:
        raise AssertionError("batched replay: scan_seq did not reach T")

    # (c) every instance against the single-instance replay
    dev0 = mesh[0]
    _, souts = replay(init_state(cfg, t0=t0, device=dev0),
                      type(seq)(*[f.to(dev0) for f in seq]), cfg,
                      device=dev0)
    sposes = souts.pose.cpu().numpy()
    diffs = [float(np.abs(bposes[i] - sposes).max()) for i in range(n)]
    for i, d in enumerate(diffs):
        if not d < INSTANCE_TOL:
            raise AssertionError(
                f"instance {i} of the batched replay diverges from the "
                f"single-instance replay: max|d|={d}")

    # (d) the memory envelope of the production config on the card: it
    # admits 8 instances and refuses the smallest count whose estimated
    # peak exceeds the card's memory (no allocation: the state's bytes
    # come from meta tensors).
    prod = GCConfig.tpu()
    limit = device_hbm_bytes(dev0) if dev0.type == "cuda" else H100_HBM_BYTES
    env8 = assert_memory_envelope(prod, 8, limit_bytes=limit)
    per = memory_envelope(prod, 1)["peak_bytes_est"]
    n_refused = limit // per + 1
    while memory_envelope(prod, n_refused - 1)["peak_bytes_est"] > limit:
        n_refused -= 1
    assert_memory_envelope(prod, n_refused - 1, limit_bytes=limit)
    try:
        assert_memory_envelope(prod, n_refused, limit_bytes=limit)
    except ValueError:
        pass
    else:
        raise AssertionError(f"{n_refused} production instances must exceed "
                             f"the {limit / 1e9:.1f} GB envelope")
    if dev0.type == "cuda":
        torch.cuda.synchronize(dev0)
    return {"devices": [str(d) for d in mesh], "step_poses": poses,
            "replay_scans": T, "instance_max_abs_diff": diffs,
            "limit_bytes": int(limit), "limit_source": (
                "torch.cuda.mem_get_info" if dev0.type == "cuda"
                else "H100 80 GB nominal"),
            "peak_bytes_est_8": env8["peak_bytes_est"],
            "n_refused": int(n_refused)}

