"""Budgets, priors, and epsilons for the GC-SLAM engine (PyTorch port).

A copy of ``fl_slam_tpu/config.py`` with every knob, ``small()``, ``tpu()``
and ``validate()`` unchanged; ``torch_dtype`` replaces the JAX ``jdtype``.
The port runs every configuration the reference runs: ``GCConfig()`` (the
reference-parity bank of K = 4 and the per-slot view), ``small()``,
``tpu()`` and real MHT (``hyp_init_spread_*`` > 0).

Eighteen fields are accepted and read nowhere in the port: ``eps_den``,
``weight_floor``, ``c_dt``, ``c_ex``, ``odom_z_variance_prior``,
``ringbuf_len``, ``surfel_max_occupants``, ``r_stencil_xy`` and
``r_stencil_z`` (only the unread ``n_stencil_tiles`` property uses them),
``kappa_min``, ``kappa_max``, ``fuse_chunk``, ``assoc_block``,
``scan_unroll`` (only ``validate()`` reads it) and the kernel switches
``slab_dma_kernel``, ``sinkhorn_kernel``, ``fuse_moment_kernel`` and
``surfel_moment_kernel``. They stay because the copy is the reference's
field for field, so that one set of keyword arguments builds both
configurations; ``tests/test_torch_core.py`` holds this list. The kernel
switches pick, in the reference, between a TPU kernel and an XLA form of
the same function. The port has one implementation of each: the
hand-written CUDA kernel (K3, K4, K5) on CUDA tensors, its plain PyTorch
twin on CPU tensors, whatever the switch says; ``fuse_moment_kernel=False``
does not become a float-atomic ``index_add_``, which would break the
bit-identical reruns. ``belief_kernel`` runs K1/K2 only at ``k_hyp=1``, as
in the reference.

The reference keeps these as module-level constants ("constants are
priors/budgets", ``common/constants.py:55-489``) validated against YAML at node
start. Here they live in one frozen, hashable dataclass passed as a *static*
argument to every jitted entry point: changing a budget recompiles, exactly the
fixed-cost contract the reference enforces at runtime
(``backend/backend_node.py:548-586``), but by construction.

All default values mirror the reference's published priors/budgets
(``common/constants.py``) so that behavior is comparable; ``GCConfig.small()``
is a reduced-budget variant for fast CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# ---------------------------------------------------------------------------
# 22D augmented state layout (chart GC-RIGHT-01).
# [trans(0:3), rot(3:6), vel(6:9), bg(9:12), ba(12:15), dt(15), ex(16:22)]
# Parity: common/constants.py:113-138.
# ---------------------------------------------------------------------------
D_Z = 22
CHART_ID = "GC-RIGHT-01"

IDX_TRANS = slice(0, 3)
IDX_ROT = slice(3, 6)
IDX_VEL = slice(6, 9)
IDX_BG = slice(9, 12)
IDX_BA = slice(12, 15)
IDX_DT = slice(15, 16)
IDX_EX = slice(16, 22)
IDX_POSE = slice(0, 6)

# Block structure used by the process-noise IW state: 7 blocks, padded to 6x6.
# [trans(3), rot(3), vel(3), bg(3), ba(3), dt(1), ex(6)]
PROCESS_BLOCKS: Tuple[Tuple[int, int], ...] = (
    (0, 3), (3, 6), (6, 9), (9, 12), (12, 15), (15, 16), (16, 22),
)
N_PROCESS_BLOCKS = len(PROCESS_BLOCKS)

GRAVITY_W = (0.0, 0.0, -9.81)  # Z-up world; gravity points down.
GRAVITY_MAG = 9.81


@dataclasses.dataclass(frozen=True)
class GCConfig:
    """Compile-time budgets and priors. Hashable; pass as static to jit."""

    # ---- dtypes -----------------------------------------------------------
    # Belief/info algebra dtype and point-cloud dtype. CPU parity tests use
    # f64/f64; TPU production uses f32/f32 (f64 is emulated and slow on TPU).
    dtype: str = "float32"

    # ---- fixed-cost budgets (constants.py:55-75) --------------------------
    k_hyp: int = 4
    hyp_weight_floor: float = 0.0025
    # MHT semantics (this build; the reference's K=4 bank keeps all
    # hypotheses identical with frozen uniform weights — dead compute,
    # docs/PIPELINE_DESIGN_GAPS.md:396). Here hypothesis k>0 starts from a
    # deterministically perturbed anchor (alternating yaw/x/y offsets scaled
    # by these spreads) and per-scan weights get a Bayes update from each
    # hypothesis's own odometry-innovation NLL (its marginal-likelihood
    # proxy), feeding the barycenter. Spread 0 = reference-parity identical
    # bank (weights then stay uniform since the NLLs are identical).
    #
    # MEASURED LIMIT (round 5, kidnapped-start probe at production scale):
    # the bank CANNOT sustain hypothesis diversity under this build's (and
    # the reference's) shared evidence — the initial belief is nearly
    # uninformative, so the first scan's absolute factors crush every
    # perturbed mean to the same posterior (spread 0.25 rad/0.3 m with a
    # 0.25 rad kidnapped anchor: all four configs bit-identical ATE).
    # True MHT needs per-hypothesis association/maps (4x the map cost),
    # which neither build carries. Production therefore runs k_hyp=1
    # (GCConfig.tpu()); k_hyp=4 remains the reference-parity configuration
    # and the mechanically-working Bayes bank its tested upgrade surface
    # (tests/test_pipeline_e2e.py MHT tests).
    hyp_init_spread_rot: float = 0.0    # rad, yaw-first perturbation scale
    hyp_init_spread_trans: float = 0.0  # m
    hyp_nll_temp: float = 1.0           # likelihood temperature for weights
    n_points: int = 8192            # LiDAR points per scan after budget resample
    imu_len: int = 512              # fixed IMU preintegration window length

    # ---- epsilons (constants.py:70-78) ------------------------------------
    eps_psd: float = 1e-12
    eps_lift: float = 1e-9
    eps_mass: float = 1e-12
    eps_r: float = 1e-6
    eps_den: float = 1e-12
    exc_eps: float = 1e-12
    weight_floor: float = 1e-12
    nonfinite_sentinel: float = 1e6

    # ---- fusion / trust (constants.py:88-100) ------------------------------
    alpha_min: float = 1.0
    alpha_max: float = 1.0
    kappa_scale: float = 1.0
    c0_cond: float = 1e6
    kappa_blend_r0: float = 0.8
    kappa_blend_tau: float = 0.03
    c_dt: float = 1.0
    c_ex: float = 1.0
    c_frob: float = 1.0

    # ---- anchor drift (constants.py:104-106) -------------------------------
    anchor_drift_m0: float = 0.5
    anchor_drift_r0: float = 0.2

    # ---- time warp ----------------------------------------------------------
    time_warp_sigma_frac: float = 0.1

    # ---- sensor noise priors (constants.py:164-230) -------------------------
    imu_gyro_noise_density: float = 8.7e-7    # rad^2/s (PSD)
    imu_accel_noise_density: float = 9.5e-5   # m^2/s^3 (PSD)
    lidar_sigma_meas: float = 0.01            # m^2 (discrete)
    imu_accel_scale: float = 1.0              # input already m/s^2 for Kimera/synth
    accel_bias_sigma: float = 0.2             # m/s^2; gravity-magnitude ba factor
    # Precision scale on the ba factor's gravity-PERPENDICULAR components.
    # r_ba's perpendicular part is tilt-ambiguous; feeding it to the
    # body-frame ba state at full precision closes an unstable
    # tilt-precession loop under yaw (spin-in-place fixture: 0.1 -> 18.6
    # deg in 1,024 scans; the straight-line variant holds 0.1 deg). See
    # ops/imu.accel_bias_evidence.
    ba_perp_scale: float = 0.05

    # ---- process diffusion priors (constants.py:232-249) --------------------
    q_trans: float = 1e-4
    q_rot: float = 8.7e-7
    q_vel: float = 9.5e-5
    q_bg: float = 1e-8
    q_ba: float = 1e-6
    q_dt: float = 1e-6
    q_ex: float = 1e-8

    # ---- OU damping (constants.py:252-266) ----------------------------------
    ou_lambda: float = 0.1

    # Physical ceilings for the ADAPTIVE process noise (per-axis variance
    # rate). The IW adaptation is a positive-feedback loop (looser prior ->
    # larger residuals -> larger suffstats); without a ceiling Q_rot_z was
    # observed to inflate 5 orders of magnitude and walk the yaw away. The
    # ceilings encode the platform envelope (a ground robot cannot diffuse
    # faster than ~0.5 m/sqrt(s) or ~3 deg/sqrt(s)).
    q_max_trans: float = 0.25     # m^2/s
    q_max_rot: float = 2.5e-3     # rad^2/s
    q_max_vel: float = 0.25
    q_max_bg: float = 1e-6
    q_max_ba: float = 1e-4
    q_max_dt: float = 1e-4
    q_max_ex: float = 1e-6

    # ---- IW retention (constants.py:267-283) --------------------------------
    iw_nu_weak_add: float = 0.5
    iw_rho_trans: float = 0.99
    iw_rho_rot: float = 0.995
    iw_rho_vel: float = 0.95
    iw_rho_bg: float = 0.999
    iw_rho_ba: float = 0.999
    iw_rho_dt: float = 0.9999
    iw_rho_ex: float = 0.9999
    iw_rho_meas_gyro: float = 0.995
    iw_rho_meas_accel: float = 0.995
    iw_rho_meas_lidar: float = 0.99

    # ---- planar robot priors (constants.py:285-320) -------------------------
    planar_z_ref: float = 0.0
    planar_z_sigma: float = 0.1
    planar_vz_sigma: float = 0.01
    odom_z_variance_prior: float = 1e6

    # ---- odom twist (constants.py:322-335) ----------------------------------
    odom_twist_vel_sigma: float = 0.1
    odom_twist_wz_sigma: float = 0.01

    # ---- range weighting (constants.py:258-261) ------------------------------
    range_weight_sigma: float = 0.25
    range_weight_min_r: float = 0.5
    range_weight_max_r: float = 50.0

    # ---- measurement / association budgets (constants.py:339-380) -----------
    n_feat: int = 512
    n_surfel: int = 1024
    k_assoc: int = 8
    k_sinkhorn: int = 50
    ot_epsilon: float = 0.1
    ot_tau_a: float = 0.5
    ot_tau_b: float = 0.5
    ringbuf_len: int = 5

    # ---- power tempering (pipeline.py:118-121) -------------------------------
    power_beta_min: float = 0.25
    power_beta_exc_c: float = 50.0
    power_beta_z_c: float = 1.0

    # ---- scan-to-map evidence tempering (this build; not in the reference) ---
    # The OT/WLS visual evidence is a product of per-surfel precisions and is
    # overconfident by construction (mm-level sigma): untempered it couples
    # the pose rigidly to the map and the map->insert->associate loop echoes
    # estimate bias (observable as a z random walk). Tempering keeps it
    # informative but subordinate to the kinematic evidence.
    # 0.3 post shape-aware WLS won the round-1 sweep; re-swept TWICE at
    # round-2 production budgets: 0.6 with the old uniform OT marginal, then
    # 0.45 after the weight-proportional transport marginal landed (that
    # change alone cut translation ATE ~43% but firmed the map grip; the
    # trans/rot trade curve moved: 0.45/0.6/0.8 -> 1.08/1.24/1.50 deg rot
    # and 0.101/0.086/0.080 m trans on seed 0). 0.45 keeps rotation at the
    # old baseline while taking a -40% translation win (3-seed mean
    # 0.112 m / 1.048 deg vs 0.188 / 1.063 pre-session).
    visual_evidence_weight: float = 0.45
    # Rotation-block gain INSIDE the visual evidence (multiplies the
    # matrix-Fisher (L_r, h_r) before the 22D embed, on top of
    # visual_evidence_weight which scales both blocks). The two blocks want
    # different strengths: the round-2 joint sweep moved on a coupled
    # trans/rot trade curve (0.45/0.6/0.8 -> rot 1.08/1.24/1.50 deg while
    # trans 0.101/0.086/0.080 m) precisely because one knob scaled both.
    visual_rot_weight: float = 1.0
    # Age gate of the rotation scatter (scans; 0 = off). The 1.1-deg yaw
    # plateau is a map-drag equilibrium: the map is built at the lagged
    # estimate poses and rotates WITH the drift, then the scatter aligns
    # pose to the rotated map (round-3 nine-lever sweep: no weight fixes
    # it). Gating each candidate by age/(age + tau), age = scan_seq -
    # created_seq, makes mature, settled primitives (whose direction
    # averages over many historical poses — drift-diluted) anchor yaw
    # while freshly-inserted ones (built at the current drifted pose — the
    # ratchet's pawls) carry no rotation vote.
    visual_rot_age_tau: float = 60.0

    # Translation WLS pair weighting: (1-f) * point-to-plane + f * point-to-
    # point. Pure point-to-plane (f=0) kills the along-wall aperture bias but
    # surrenders the in-plane pull that corrects drifting odometry between
    # differently-oriented surfaces; a small isotropic floor keeps both.
    p2p_shape_floor: float = 0.1

    # Relative-IMU factor weight (gyro rotation + preint velocity/position
    # factors). With the mechanized prediction these factors re-state the
    # prediction's own information at ~1e6-1e7 precision WITHOUT the pose-vel
    # cross terms a correct joint factor would carry — pure double counting
    # that crushes every absolute evidence source (the reference runs them
    # against a static-mean prediction and pays with its documented meter-
    # level lag modes). Kept as operators; off in the default pipeline.
    imu_factor_weight: float = 0.0

    # ---- per-group evidence weights (ablation knobs, reference pattern of
    # imu_gravity_scale/deskew_rotation_only; all 1.0 = full pipeline) -------
    odom_pose_weight: float = 1.0
    # RELATIVE odometry factor: compare the scan-to-scan odometry INCREMENT
    # against the previous pose ESTIMATE instead of the integrated absolute
    # odom pose. Wheel odometry is physically an increment sensor; its
    # absolute pose integrates drift, and the absolute factor drags the
    # estimate toward that accumulated drift at the message covariance's
    # full confidence (the drifting-odometry benchmark's dominant yaw-error
    # mechanism). Relative mode keeps the factor's short-horizon stiffness
    # (per-step increments are drift-free to first order) without the drag.
    # First scan falls back to the absolute factor (anchors the start).
    odom_pose_relative: bool = False
    # In relative mode, fraction of the ABSOLUTE pose factor blended back in
    # (0 = pure relative, 1 = pure absolute). The absolute share supplies
    # the anchor that keeps the relative system from random-walking; its
    # rotation block is additionally scaled by odom_pose_rot_scale so the
    # accumulated yaw drift drags weakly while translation anchors fully.
    odom_pose_mix: float = 0.5
    # Information scale on the odom pose factor's ROTATION block only
    # (1.0 = the message covariance verbatim). The wheel odometry's yaw is
    # its systematically-drifting axis; this scales L_rot (and the cross
    # block by sqrt) without touching the load-bearing translation rows.
    odom_pose_rot_scale: float = 1.0
    odom_twist_weight: float = 1.0
    planar_weight: float = 1.0
    # The pose-twist kinematic factor uses the SAME odom twist sample as the
    # velocity/yawrate factors (triple counting) with Sigma = dt^2 Sigma_twist
    # — precision ~1e6 that injects raw odom twist noise into pose each scan.
    # Kept as an operator; off in the default pipeline.
    odom_kinematic_weight: float = 0.0

    # Innovation feed into adaptive Q, per pose sub-block. Both feeds are
    # needed (pred-vs-post alone can never loosen an overconfident prior;
    # gating the rotation feed was tried on the drifting-odometry benchmark
    # and degrades rotation 6.9 -> 15.9 deg by freezing the yaw prior).
    innovation_q_trans: float = 1.0
    innovation_q_rot: float = 1.0
    # Component-wise clip on the fed innovation: an unbounded feed is a
    # positive-feedback loop (larger Q -> looser prior -> larger wander ->
    # larger innovation -> larger Q; observed as Q_rot_z inflating from
    # 8.7e-7 to 0.12 rad^2/s and a pure-yaw runaway after ~150 scans). The
    # clip bounds the learned per-scan prediction-error scale.
    innovation_clip_trans: float = 0.30   # m (loose; Q is bounded below)
    innovation_clip_rot: float = 0.10     # rad

    # ---- ablation knobs (pipeline.py:138-146) --------------------------------
    imu_gravity_scale: float = 1.0
    deskew_rotation_only: bool = False

    # ---- surfel extraction (MA-Hex-3D) ---------------------------------------
    # Adaptive per-scan cell-size scaling (ops/surfels.py): the fixed-count
    # grid covers only ~8.8 m axial radius at the configured size; scaling
    # by the scan's p95 xy radius keeps long-range geometry represented
    # (89% of point mass was out-of-grid on the Kimera-layout fixture).
    surfel_adaptive_cells: bool = True
    surfel_cell_size: float = 0.5
    surfel_cells_1: int = 32
    surfel_cells_2: int = 32
    surfel_cells_z: int = 8
    surfel_max_occupants: int = 32

    # ---- map / atlas (constants.py:382-489) ----------------------------------
    # Primitive capacity per tile. 50176 = 49 * 1024: >= the reference's
    # 50,000 budget AND divisible by 8*128, which tile-aligns the resident-
    # slab DMA blocks (structures/atlas_kernels.py needs M % 128 == 0 for
    # fdata and (8, M/8) with M/8 % 128 == 0 for the prim-id view).
    m_tile: int = 50176
    n_tiles_pool: int = 64           # fixed tile-pool size (device array axis)
    # Tile size must cover the sensor range: the active hex disk (radius
    # r_active_xy) is where surfels can be inserted and associated. The
    # reference's 2.0 m tiles with a radius-1 disk silently drop every
    # measurement beyond ~4 m of the robot — most of a lidar sweep.
    h_tile: float = 10.0
    r_active_xy: int = 1
    r_active_z: int = 0
    r_stencil_xy: int = 1
    r_stencil_z: int = 0
    m_tile_view: int = 1024
    recency_decay_lambda: float = 0.02
    recency_min_scale: float = 0.05
    forgetting_factor: float = 0.995
    merge_threshold: float = 0.1
    k_merge_pairs: int = 4
    # Merge candidates per tile = top-merge_max_tile by weight. The reference
    # caps the O(M^2) pass at 2048 (and NO-OPS whenever the tile is larger, so
    # merging never runs at production size); 256 keeps merge active at ~2 ms
    # instead of ~340 ms on a v5e chip (the profiled top cost of the scan).
    merge_max_tile: int = 256
    # Cull threshold sized to the novelty-insertion mass scale: a genuinely
    # novel measurement inserts with weight ~ (1/N_valid) * surfel_mass
    # (~0.05 at production budgets); residual-novelty slivers land 10-100x
    # lower and must die, or the map grows by ~170 near-duplicates per scan
    # (observed: 20k primitives after 200 scans, degraded pose evidence).
    # The reference's 1e-4 keeps the slivers.
    cull_weight_threshold: float = 0.01
    kappa_min: float = 1e-3
    kappa_max: float = 1e4
    vmf_n_lobes: int = 3
    fuse_chunk: int = 1024
    assoc_block: int = 256
    k_insert: int = 64

    # TPU-optimized approximate top-k (jax.lax.approx_max_k, recall ~0.95
    # per element) for the three large per-scan selections: map-view top-by-
    # weight/recency over (S, m_tile), insert-eviction lowest-retention, and
    # association candidate top-K over the dense cost. Deterministic; the
    # selections feed SOFT machinery (Sinkhorn responsibilities, retention
    # eviction) so a ~5% tail miss is semantically benign. Exact top_k
    # remains the default for CPU parity tests.
    approx_topk: bool = False
    # Materialize the association candidate SCORE matrix in bfloat16: that
    # selection is bandwidth-bound (the (n_meas, V) cost matrix is ~44 MB in
    # f32) and feeds soft machinery that recomputes exact f32 costs for the
    # selected candidates, so the only effect is rank swaps among candidates
    # within ~0.4% of each other. (The view/eviction selections measured
    # SLOWER in bf16 — they are sort-bound — and stay f32 regardless.)
    # Exact f32 selection remains the default for CPU parity tests.
    select_bf16: bool = False
    # Chunked view residency: the candidate view's MEMBERSHIP (selection +
    # gather) and the slab write-back scatter run once every R scans at a
    # STATIC chunk boundary of the replay scan (no predication); between
    # boundaries the view rows stay resident in the carry and fuse/merge
    # update them in place. R=1 is exact per-scan semantics (the default and
    # the parity-test path). R>1 trades bounded staleness (membership,
    # tile-set activation, forget/inflate/cull granularity — all <= R-1
    # scans, ~0.4 s at R=4/10 Hz) for removing the dominant per-scan map
    # costs (write-back scatter ~350 us, selection ~130 us, gather ~60 us).
    view_refresh_every: int = 1
    # PAGED view membership: when > 0, view residency is selected in pages of
    # ``view_page`` contiguous slots (lane-aligned at 128 on TPU) instead of
    # per slot. Page scores: weight half = sum of valid-slot weights, recency
    # half = max created_seq; inserts cluster into the lowest-retention
    # non-resident page of each tile. Turns the boundary gather + write-back
    # (~7168 strided columns, ~48 ns/col each way — the top remaining sink)
    # and the prim-id gather into a handful of tile-aligned page slices the
    # DMA engine can stream, and the big (S, m_tile) selection sorts into
    # tiny exact (S, m_tile/P) ones. Trade: membership/merge/eviction become
    # page-granular (an isolated heavy primitive in an otherwise-dead page
    # can lose view residency). 0 = per-slot selection (reference-shaped
    # membership; the CPU parity default). Requires m_tile % view_page == 0
    # and m_tile_view % view_page == 0.
    view_page: int = 0
    # Not read by the port (module docstring).
    slab_dma_kernel: bool = True
    # Not read by the port (module docstring).
    sinkhorn_kernel: bool = True
    # Fuse the candidate SELECTION (proxy cost + top-k) into one Pallas
    # kernel (ops/assoc_kernels.select_candidates): the cost is bilinear in
    # meas/candidate features, so it runs as one (128, 16) @ (16, 128) MXU
    # dot per lane chunk entirely in VMEM — the XLA path materializes two
    # (N, V) matrices in HBM plus a bucket sort (~125 us/scan attributed).
    # TPU-only with N, V multiples of 128 (auto-falls back elsewhere);
    # same vmap caveat as slab_dma_kernel.
    select_kernel: bool = False
    # Not read by the port (module docstring).
    fuse_moment_kernel: bool = False
    # Not read by the port (module docstring).
    surfel_moment_kernel: bool = False
    # Paged insert write-back as a DENSE target-page rewrite (merge the SK
    # proposals into the gathered page, write the same contiguous page
    # columns back) instead of an unsorted drop-mode column scatter.
    # MEASURED SLOWER (1.060 vs 1.013 ms/scan interleaved A/B on the v5e:
    # the merge einsum + full-page stores cost more than the 448-column
    # drop scatter) — kept as tested infrastructure, default off.
    insert_page_dense: bool = False
    # Camera features as MAP-INSERT proposals. Off = camera contributes
    # pose evidence, fuse-into-existing mass and color provenance but never
    # proposes new primitives (lidar surfels own map geometry). Ablation
    # axis for the round-3 open issue (docs/PERF_NOTES.md): camera-derived
    # point primitives at production budgets degraded accuracy
    # weight-independently.
    camera_insert: bool = True
    # Novelty floor for VALID camera rows at insertion (0 = off). On a
    # lidar-explained surface the unbalanced-OT novelty of a camera feature
    # is ~0, so camera LANDMARKS (texture corners — the only along-track
    # reference in degenerate corridors) never enter the map and the camera
    # can never improve the estimate there. A small floor lets the top
    # camera features compete for the insert budget; camera-born primitives
    # keep the full (near-isotropic) camera Lambda, so later visual-WLS
    # matches against them constrain the in-plane directions lidar surfels
    # cannot (point-to-plane shape weighting zeroes those rows).
    camera_insert_novelty_floor: float = 0.0
    # Scale on the GEOMETRY (Lambda, theta) contribution of camera-source
    # rows in the map fuse — mean-preserving (mu = Lambda^{-1} theta is
    # unchanged), mass-reducing. 1.0 = reference PoE fuse. The round-5
    # camera residual gap (docs/PERF_NOTES.md: camera-on 0.174 m vs 0.124 m
    # camera-off at production scale) was suspected fuse-side: camera
    # backprojection Lambdas are near-isotropic, so fusing them into
    # lidar-surfel primitives fattens the in-plane precision and erodes the
    # plane form that the point-to-plane evidence relies on. 0.0 = camera
    # rows still fuse weight/color/appearance (vMF) mass but leave the
    # Gaussian geometry to lidar. Applies ONLY to fuse-into-existing; camera
    # INSERT proposals (camera_insert) keep their full Lambda.
    # Valid range [0, 1]; values outside are clamped at the consumption site
    # (_fuse_base_rows) — a negative scale would SUBTRACT camera precision
    # from fused primitives and silently break the Lambda^-1 theta decode.
    camera_fuse_geom_scale: float = 1.0
    # Run the K=1 belief chain as the two belief kernels
    # (ops/belief_kernels.py): K1 predict + evidence, K2 the scalar tail
    # (steps 9-15 + IW apply), at k_hyp=1 only (a bank of K > 1 runs op by
    # op). In the port this holds on every device: a CUDA tensor launches
    # the kernels, a CPU tensor runs their plain versions. False = the
    # op-by-op branch (the reference's XLA path).
    belief_kernel: bool = True
    # Run merge-reduce once per view chunk (on the freshly gathered view at
    # _chunk_begin — exactly when newly written-back/inserted duplicates
    # become view-matchable) instead of once per scan. False = reference
    # cadence (merge every scan, primitive_map.py:1501). Bounded delta:
    # duplicates persist <= view_refresh_every-1 extra scans; in paged mode
    # mid-chunk inserts are not view-matchable before the refresh anyway.
    merge_at_chunk: bool = False
    # Not read by the port (module docstring).
    scan_unroll: int = 1

    # ------------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]

    @property
    def n_active_tiles(self) -> int:
        return (2 * self.r_active_z + 1) * _hex_disk_count(self.r_active_xy)

    @property
    def n_stencil_tiles(self) -> int:
        return (2 * self.r_stencil_z + 1) * _hex_disk_count(self.r_stencil_xy)

    @property
    def n_meas(self) -> int:
        """Total measurement-primitive budget (camera slice + lidar slice)."""
        return self.n_feat + self.n_surfel

    def replace(self, **kw) -> "GCConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "GCConfig":
        """Fail-fast range/consistency checks on the tunable knobs (parity:
        the reference's budget/param validation at node start,
        backend_node.py:548-586). Called from init_state so every replay
        entry point inherits the gate; returns self for chaining.

        The checks cover knobs whose out-of-range values fail SILENTLY
        (sign flips in fused information, negative variances, divisibility
        assumptions) — in-range behavior is never affected.
        """
        def chk(cond, msg):
            if not cond:
                raise ValueError(f"GCConfig.validate: {msg}")

        chk(self.n_points > 0 and self.imu_len > 0 and self.n_surfel > 0
            and self.n_feat >= 0, "budgets must be positive")
        chk(self.k_hyp >= 1, "k_hyp >= 1")
        chk(self.k_assoc >= 1 and self.k_sinkhorn >= 1, "OT budgets >= 1")
        chk(0.0 <= self.camera_fuse_geom_scale <= 1.0,
            f"camera_fuse_geom_scale in [0, 1] (a negative value SUBTRACTS "
            f"camera precision from fused primitives); got "
            f"{self.camera_fuse_geom_scale}")
        for name in ("visual_evidence_weight", "visual_rot_weight",
                     "odom_pose_weight", "odom_twist_weight",
                     "planar_weight", "imu_factor_weight",
                     "odom_kinematic_weight", "odom_pose_rot_scale",
                     "kappa_scale", "imu_gravity_scale"):
            chk(getattr(self, name) >= 0.0, f"{name} must be >= 0 (a "
                f"negative evidence weight flips the information sign)")
        chk(0.0 <= self.odom_pose_mix <= 1.0, "odom_pose_mix in [0, 1]")
        chk(0.0 < self.forgetting_factor <= 1.0,
            "forgetting_factor in (0, 1]")
        chk(self.recency_decay_lambda >= 0.0, "recency_decay_lambda >= 0")
        chk(0.0 < self.recency_min_scale <= 1.0,
            "recency_min_scale in (0, 1]")
        for name in ("eps_psd", "eps_lift", "eps_mass", "ot_epsilon",
                     "ot_tau_a", "ot_tau_b", "planar_z_sigma",
                     "planar_vz_sigma", "odom_twist_vel_sigma",
                     "odom_twist_wz_sigma", "accel_bias_sigma"):
            chk(getattr(self, name) > 0.0, f"{name} must be > 0")
        chk(self.m_tile_view <= self.m_tile,
            "m_tile_view <= m_tile")
        if self.view_page > 0:   # 0 = paged view mode off
            chk(self.m_tile % self.view_page == 0,
                "view_page must divide m_tile")
            chk(self.k_insert <= self.view_page,
                "k_insert <= view_page (one page must hold a scan's "
                "inserts)")
        chk(self.scan_unroll >= 1 and self.view_refresh_every >= 1,
            "cadence knobs >= 1")
        return self

    # ------------------------------------------------------------------
    @staticmethod
    def small(**overrides) -> "GCConfig":
        """Reduced budgets for fast CPU tests (shape logic identical)."""
        base = dict(
            dtype="float64",
            n_points=256,
            imu_len=64,
            n_feat=16,
            n_surfel=64,
            k_assoc=4,
            k_sinkhorn=10,
            surfel_cells_1=16,
            surfel_cells_2=16,
            surfel_cells_z=8,
            surfel_max_occupants=16,
            m_tile=256,
            n_tiles_pool=16,
            h_tile=8.0,
            m_tile_view=128,
            merge_max_tile=256,
            fuse_chunk=64,
            assoc_block=32,
            k_insert=16,
        )
        base.update(overrides)
        return GCConfig(**base)

    @staticmethod
    def tpu(**overrides) -> "GCConfig":
        """Production budgets, float32 compute.

        k_hyp=1: the reference runs K_HYP=4 but its bank is semantically
        inert — all hypotheses see identical inputs, weights stay frozen
        uniform, the map updates from hypothesis 0, and the barycenter of
        identical beliefs is that belief (``backend_node.py:2079-2083``,
        ``docs/PIPELINE_DESIGN_GAPS.md:396``). K=1 therefore reproduces the
        reference configuration's estimates exactly (gated by
        test_pipeline_e2e ``test_inert_bank_equals_k1``) at 1/4 the 22D
        algebra. Real MHT (this build's upgrade) = k_hyp=4 +
        hyp_init_spread_* > 0, which makes the bank carry distinct
        hypotheses and live weights.
        """
        # Chunk cadence R=10: 1.038 -> 1.022 ms/scan (interleaved best-of-4)
        # at unchanged accuracy (0.117 m / 1.090 deg 3-seed gate). R=20
        # measured 0.997 but degrades the 2 m/s fast-motion stress
        # 0.108 -> 0.153 m (membership staleness 2.0 s) — rejected.
        # m_tile_view 1024 -> 768 (6 view pages/tile): shrinks the (N, V)
        # selection matrices and view top-k ~25%; 1.008 vs 1.002/0.999
        # interleaved, accuracy 0.123 m / 1.104 deg (in the seed band; 512
        # measured 0.980 ms but 0.132 m — rejected).
        base = dict(dtype="float32", approx_topk=True, select_bf16=True,
                    m_tile_view=768,
                    view_refresh_every=10, view_page=128, k_hyp=1,
                    merge_at_chunk=True,
                    # unroll=2 lets XLA's scheduler overlap scan t+1's
                    # measurement-side front (deskew/surfels/windows) with
                    # scan t's belief tail: 1.105 -> 1.082 ms/scan
                    # (interleaved best-of-4, docs/PERF_NOTES.md round 5)
                    scan_unroll=2,
                    # factored one-hot MXU moment kernel: 1.059 -> 1.026
                    # ms/scan (device parity 3.7e-6 rel at production shape)
                    surfel_moment_kernel=True,
                    # same contraction for the compact-fuse scatter: 0.924
                    # -> 0.891 ms/scan interleaved A/B; accuracy in the
                    # seed band (0.118 m / 1.113 deg 3-seed)
                    fuse_moment_kernel=True,
                    # camera rows fuse weight/color/appearance but NOT
                    # Gaussian geometry: the round-3 sweep confirmed the
                    # fuse-side hypothesis for the camera-on translation
                    # gap — camera-on 0.171/0.154/0.141/0.129 m at
                    # gs = 1.0/0.5/0.25/0.0 (3-seed; camera-off band
                    # 0.111-0.142 m — 0.0 is IN BAND). Camera INSERT
                    # proposals keep full Lambda; a no-op camera-off.
                    camera_fuse_geom_scale=0.0)
        base.update(overrides)
        return GCConfig(**base)


def _hex_disk_count(r: int) -> int:
    """Cells in a radius-r hex disk: 1 + 3r(r+1)."""
    r = max(int(r), 0)
    return 1 + 3 * r * (r + 1)


DEFAULT_CONFIG = GCConfig()

