"""Device-memory envelope of an instance-batched replay (port of
``fl_slam_tpu/certs.py:189-271``: ``pytree_bytes``, ``device_hbm_bytes``,
``memory_envelope``, ``assert_memory_envelope``).

``state_bytes`` is exact and allocates nothing: ``init_state`` runs on the
``meta`` device. The peak model is

    peak = n_instances * PEAK_FACTOR * state_bytes + staged_bytes

with the port's own factor, measured on the card (not the reference's 2.5,
which was calibrated on a TPU).
"""

from __future__ import annotations

import os

import torch
import torch.utils._pytree as pytree

from fl_slam_tpu_torch.config import GCConfig

# Peak device bytes of the B = 8 batched replay of GCConfig.tpu() (100
# scans) over B x state_bytes, rounded up: chip_smoke.py phase 6 measured
# 1.58 (5.95 GB over 8 x 470 MB) on an NVIDIA H100 80GB HBM3 at 700 W. The
# live states are 1x; the rest is the stacked scan inputs, the per-scan
# working set and the outputs.
PEAK_FACTOR = 1.6


def pytree_bytes(tree) -> int:
    """Total bytes of the tensors of a (nested) tuple / dict of tensors."""
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def device_hbm_bytes(device=None) -> int | None:
    """Bytes this process can use on ``device`` (default: the current CUDA
    device): the free memory plus what PyTorch's allocator holds, from
    ``torch.cuda.mem_get_info``. None on the CPU or without a card. The
    environment variable ``GC_HBM_BYTES`` overrides it, as in the
    reference."""
    env = os.environ.get("GC_HBM_BYTES")
    if env:
        return int(float(env))
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device))


def memory_envelope(cfg: GCConfig, n_instances: int = 1,
                    staged_bytes: int = 0) -> dict:
    """Per-device envelope for ``n_instances`` on one card."""
    from fl_slam_tpu_torch.pipeline import init_state
    state = pytree_bytes(init_state(cfg, device="meta"))
    peak = int(n_instances * PEAK_FACTOR * state) + int(staged_bytes)
    return {"state_bytes": int(state), "n_instances": int(n_instances),
            "staged_bytes": int(staged_bytes), "peak_factor": PEAK_FACTOR,
            "peak_bytes_est": peak}


def assert_memory_envelope(cfg: GCConfig, n_instances: int = 1,
                           staged_bytes: int = 0, device=None,
                           limit_bytes: int | None = None) -> dict:
    """Raise before anything is allocated when the estimated peak exceeds
    the device's memory. Returns the envelope; no check where the limit is
    unknown (the CPU without ``limit_bytes``)."""
    env = memory_envelope(cfg, n_instances, staged_bytes)
    limit = limit_bytes if limit_bytes is not None else \
        device_hbm_bytes(device)
    env["limit_bytes"] = limit
    if limit is not None and env["peak_bytes_est"] > limit:
        per = env["state_bytes"] / 1e9
        fit = max(1, int((limit - staged_bytes)
                         / (PEAK_FACTOR * env["state_bytes"])))
        raise ValueError(
            f"memory envelope exceeded: {n_instances} instances x "
            f"{per:.2f} GB state (peak est {env['peak_bytes_est'] / 1e9:.1f}"
            f" GB incl. {staged_bytes / 1e9:.2f} GB staged scans) > device "
            f"memory {limit / 1e9:.1f} GB; max instances/device at this "
            f"config ~{fit}. Shrink the map pool (n_tiles_pool/m_tile), stage "
            "fewer scans per segment, or spread instances over more cards.")
    return env
