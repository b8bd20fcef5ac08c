"""The whole run, its look for a card skipped, at a small size on the CPU:
``correct`` comes out true on the program as it is, and false with a
fault planted under the timed path: the step's state left unchanged; in
the cells that replay segments, half of each segment's scans left out
(its outputs those of the first half again); in the cells that compare
the rotation steps, one pose's rotation altered where it is produced;
in the cells that compare the position steps, one pose's position
altered."""

import io
import json
import time

import pytest
import torch

from benchmarks import harness

SMALL_TPU = dict(k_hyp=1, view_page=64, view_refresh_every=5,
                 merge_at_chunk=True, approx_topk=True, select_bf16=True,
                 surfel_moment_kernel=True, fuse_moment_kernel=True,
                 belief_kernel=True, camera_fuse_geom_scale=0.0)
CELLS = {"tpu.replay": SMALL_TPU, "parity.step": {"k_hyp": 2},
         "tpu.step": SMALL_TPU, "tpu.bag": SMALL_TPU}


def _limits(cell: str) -> dict:
    return harness.load_json(harness.HERE / "workloads"
                             / f"{cell}.json")["limits"]


def _run(cell: str) -> dict:
    ov = {"preset": "small", "config": CELLS[cell],
          "traffic": {"n_scans": 20, "seg_len": 10, "passes": 2,
                      "n_az": 90},
          "check": {"scans": 12}}
    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(2**31 + 99),
                       "--seconds", "4", "--trace", "0"],
                      time.perf_counter(), device=torch.device("cpu"),
                      require_card=False, overrides=ov, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _state_unchanged(orig):
    def core(state, ctx, scan, cfg):
        _, ctx2, out = orig(state, ctx, scan, cfg)
        return state, ctx2, out
    return core


# fault -> (the pose's component it alters, the limits that catch it)
ALTERED = {"pose_altered": (5, ("rot_step_gap_rad", "rot_step_gap_rad_head")),
           "position_altered": (0, ("pos_step_gap_m_head",))}


def _altering_limit(cell: str, fault: str):
    lims = _limits(cell)
    return next((lims[k] for k in ALTERED[fault][1] if k in lims), None)


def _pose_altered(orig, component, limit):
    def core(state, ctx, scan, cfg):
        at = int(state.scan_seq) == 1
        new, ctx2, out = orig(state, ctx, scan, cfg)
        if at:
            bump = torch.zeros_like(out.pose)
            bump[component] = 3.0 * limit
            out = out._replace(pose=out.pose + bump)
        return new, ctx2, out
    return core


def _half_segment(orig):
    from fl_slam_tpu_torch.pipeline import ScanInput

    def replay(state, scans, cfg, device=None):
        T = int(scans.scan_start.shape[0])
        h = max(1, T // 2)
        state, out = orig(state, ScanInput(*[f[:h] for f in scans]), cfg,
                          device=device)
        idx = torch.arange(T) % h
        return state, out._replace(
            pose=out.pose[idx], stamp=out.stamp[idx],
            certs={k: v[idx] for k, v in out.certs.items()})
    return replay


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] is True, res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "check"


SEGMENTED = ("tpu.replay", "tpu.bag")
FAULTS = [(c, f) for c in sorted(CELLS)
          for f in ("state_unchanged", "half_segment", *ALTERED)
          if (f != "half_segment" or c in SEGMENTED)
          and (f not in ALTERED or _altering_limit(c, f) is not None)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    from fl_slam_tpu_torch import pipeline
    if fault == "half_segment":
        monkeypatch.setattr(pipeline, "replay", _half_segment(
            pipeline.replay))
    else:
        orig = pipeline._scan_core
        core = (_state_unchanged(orig) if fault == "state_unchanged" else
                _pose_altered(orig, ALTERED[fault][0],
                              _altering_limit(cell, fault)))
        monkeypatch.setattr(pipeline, "_scan_core", core)
    assert _run(cell)["correct"] is False
