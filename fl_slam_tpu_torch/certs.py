"""The certificate audit layer and the device-memory envelope (port of
``fl_slam_tpu/certs.py``).

Audit layer (``:33-186``, ``:274-277``): every operator returns a flat dict
of device scalars with namespaced keys ("odom_pose.nll_proxy",
"map.fused_mass", ...). ``CATEGORY_OF_PREFIX`` maps key prefixes to the cert
families, ``aggregate`` reduces a scan's certs on the device (no host
read), ``effect_pairs`` pairs each operator's predicted and realized
objective, ``compute_budget`` declares the static shapes and allocations of
a configuration, and ``tape_schema`` is the sorted key set.

Envelope (``:189-271``: ``pytree_bytes``, ``device_hbm_bytes``,
``memory_envelope``, ``assert_memory_envelope``):

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

from fl_slam_tpu_torch.config import D_Z, GCConfig

# Peak device bytes of the B = 8 batched replay of GCConfig.tpu() (100
# scans) over B x state_bytes, rounded up: chip_smoke.py phase 6 measured
# 1.58 (5.95 GB over 8 x 470 MB) on an NVIDIA H100 80GB HBM3 at 700 W. The
# live states are 1x; the rest is the stacked scan inputs, the per-scan
# working set and the outputs.
PEAK_FACTOR = 1.6

# Key prefix -> cert family (the reference's CertBundle sub-certs).
CATEGORY_OF_PREFIX = {
    "predict": "conditioning",
    "fusion": "conditioning",
    "hyp": "conditioning",
    "iw_process": "conditioning",
    "iw_meas": "conditioning",
    "odom_pose": "mismatch",
    "odom_vel": "mismatch",
    "odom_wz": "mismatch",
    "odom_kin": "mismatch",
    "odom": "influence",
    "planar_z": "mismatch",
    "planar_vz": "mismatch",
    "planar": "mismatch",
    "imu_grav": "support",
    "imu_gyro": "mismatch",
    "imu_preint": "mismatch",
    "imu_ba": "mismatch",
    "imu": "support",
    "deskew": "influence",
    "point_budget": "support",
    "surfel": "support",
    "ot": "ot",
    "visual": "mismatch",
    "map": "map_update",
    "atlas": "map_update",
    "temper": "influence",
    "exc": "excitation",
    "recompose": "influence",
    "anchor": "influence",
}

# Keys whose magnitudes are approximation triggers (a non-zero one means a
# Frobenius / PSD correction was applied).
TRIGGER_KEYS = (
    "predict.psd_projection",
    "fusion.psd_projection",
    "imu_grav.psd_projection",
    "hyp.psd_projection",
    "recompose.bch_norm",
    "iw_process.psd_projection",
    "iw_meas.psd_projection",
)

NLL_SUFFIX = ".nll_proxy"

# Each operator emits "<op>.effect_predicted" / "<op>.effect_realized";
# their divergence is the operator's realized approximation error.
EFFECT_SUFFIX_P = ".effect_predicted"
EFFECT_SUFFIX_R = ".effect_realized"

# Every operator of the scan update has a pair; ``eval.run_eval``'s schema
# gate requires the replay's pairs to be exactly this set.
EXPECTED_EFFECT_OPS = (
    "predict",
    "deskew",
    "surfel",
    "odom_pose", "odom_vel", "odom_wz", "odom_kin",
    "imu_grav", "imu_gyro", "imu_preint", "imu_ba",
    "planar",
    "ot",
    "visual",
    "fusion",
    "recompose",
    "anchor",
    "hyp",
    "iw_process", "iw_meas",
    "map", "map.insert",
)


def effect_pairs(certs: dict) -> dict:
    """{op: (predicted, realized)} for every complete effect pair present."""
    out = {}
    for k in certs:
        if k.endswith(EFFECT_SUFFIX_P):
            op = k[: -len(EFFECT_SUFFIX_P)]
            kr = op + EFFECT_SUFFIX_R
            if kr in certs:
                out[op] = (certs[k], certs[kr])
    return out


def category(key: str) -> str:
    return CATEGORY_OF_PREFIX.get(key.split(".", 1)[0], "other")


def _sum(values, z):
    total = z
    for v in values:
        total = total + v
    return total


def aggregate(certs: dict) -> dict:
    """Per-scan aggregate scalars, computed on the certs' device (each
    value a tensor; nothing is read on the host), in the floating dtype of
    the certs. Sums run in the reference's order: the dict's insertion
    order."""
    like = next(v for v in certs.values() if v.is_floating_point())
    z = torch.zeros((), dtype=like.dtype, device=like.device)
    trig = _sum((certs[k] for k in TRIGGER_KEYS if k in certs), z)
    out = {
        "agg.trigger_magnitude": trig,
        "agg.nll_total": _sum((v for k, v in certs.items()
                               if k.endswith(NLL_SUFFIX)), z),
        "agg.lift_total": _sum((v for k, v in certs.items()
                                if k.endswith(".lift")), z),
        "agg.psd_projection_total": _sum(
            (v for k, v in certs.items() if k.endswith(".psd_projection")),
            z),
        "agg.frobenius_applied": (trig > 0).to(torch.float32),
        "agg.effect_divergence": _sum(
            (torch.abs(p - r) for p, r in effect_pairs(certs).values()), z),
    }
    if "predict.cond" in certs:
        out["agg.cond_max"] = torch.maximum(certs["predict.cond"],
                                            certs.get("fusion.cond_pose6", z))
    if "ot.ess" in certs:
        out["agg.ess_total"] = certs["ot.ess"] + certs.get("imu.ess_int", z)
    return out


def compute_budget(cfg: GCConfig) -> dict:
    """Static compute and allocation declarations of ``cfg``: the reference's
    keys, with the port's own facts where the reference states one of its
    compiled program (``jit_programs``: the port runs eagerly and compiles
    no program; ``atlas_bytes_est``: the exact bytes of the port's
    field-first pool, from ``empty_atlas`` on the ``meta`` device)."""
    from fl_slam_tpu_torch.structures.atlas import empty_atlas
    itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
    n_meas = cfg.n_meas
    view = cfg.n_active_tiles * cfg.m_tile_view
    slab_prims = cfg.n_active_tiles * cfg.m_tile
    return {
        "largest_tensor_shape": (cfg.n_tiles_pool, cfg.m_tile, 3, 3),
        "assoc_cost_shape": (n_meas, view),
        "assoc_cost_bytes": n_meas * view * itemsize,
        "slab_bytes_per_field9": slab_prims * 9 * itemsize,
        "atlas_bytes_est": pytree_bytes(empty_atlas(cfg, "meta")),
        "segment_sum_k": cfg.k_assoc,
        "sinkhorn_iters": cfg.k_sinkhorn,
        "points_cap": cfg.n_points,
        "imu_len": cfg.imu_len,
        "merge_pairs_per_scan": cfg.k_merge_pairs * cfg.n_active_tiles,
        "merge_pairwise_shape": (cfg.n_active_tiles,
                                 min(cfg.merge_max_tile, cfg.m_tile),
                                 min(cfg.merge_max_tile, cfg.m_tile)),
        "state_dim": D_Z,
        # one packed copy per replayed ScanInput (a staged bag segment in
        # io.rosbag, a dataset in io.synthetic)
        "h2d_transfers_per_replay": 1,
        "host_syncs_per_scan": 0,        # certs stay on the device
        "jit_programs": 0,               # eager: kernels built by nvcc
    }


def tape_schema(certs: dict) -> tuple:
    """Sorted key schema of a scan's cert dict."""
    return tuple(sorted(certs.keys()))


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
