"""The ``tpu.sweep8`` cell (the ``batched`` drive) run whole at a small
size on the CPU, its look for a card skipped: ``correct`` comes out true
on the program as it is, and false with a fault planted in an instance
other than instance 0 (its pose's position or rotation shifted, or its
certificates exchanged with another's or put off, from scan 5 on, inside
the batched phases), so the check reads every instance's poses and
certificates. The
drive takes B from the configuration file and compares (pass, instance)
pairs."""

import io
import json
import time

import pytest
import torch

from benchmarks import harness

SMALL_TPU = dict(k_hyp=1, view_page=64, view_refresh_every=5,
                 merge_at_chunk=True, approx_topk=True, select_bf16=True,
                 surfel_moment_kernel=True, fuse_moment_kernel=True,
                 belief_kernel=True, camera_fuse_geom_scale=0.0,
                 insert_page_dense=True)
CELL = "tpu.sweep8"
B = 3


def _run() -> dict:
    ov = {"preset": "small", "config": SMALL_TPU,
          "traffic": {"n_scans": 20, "seg_len": 10, "instances": B}}
    out = io.StringIO()
    rc = harness.main(["--workload", CELL, "--seed", str(2**31 + 99),
                       "--seconds", "4", "--trace", "0"],
                      time.perf_counter(), device=torch.device("cpu"),
                      require_card=False, overrides=ov, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] is True, res["check"]
    assert res["failed"] == 0 and res["attempted"] % B == 0
    assert list(res)[-1] == "check"


def _shifted(phases, component: int, amount: float, instance: int):
    """The batched phases with ``instance``'s pose shifted in one
    component from its scan 5 on."""
    from fl_slam_tpu_torch import graphs

    def core(state, ctx, scan, cfg):
        new, ctx2, out = phases.core(state, ctx, scan, cfg)
        bump = torch.zeros_like(out.pose)
        bump[instance, component] = amount
        late = (state.scan_seq[instance] >= 5).to(out.pose.dtype)
        return new, ctx2, out._replace(pose=out.pose + late * bump)

    return graphs.Phases(phases.begin, core, phases.end)


@pytest.mark.parametrize("component,limit", [(0, "pos_step_gap_m_head"),
                                             (5, "rot_step_gap_rad")])
@pytest.mark.parametrize("instance", [1, 2])
def test_planted_fault_in_one_instance_is_not_correct(component, limit,
                                                      instance, monkeypatch):
    from fl_slam_tpu_torch.parallel import replicas
    lim = harness.load_json(harness.HERE / "workloads"
                            / f"{CELL}.json")["limits"][limit]
    monkeypatch.setattr(replicas, "PHASES", _shifted(
        replicas.PHASES, component, 3.0 * lim, instance))
    res = _run()
    assert res["correct"] is False
    assert res["check"][limit]["value"] > lim


def _certs_faulted(phases, fault: str, instance: int):
    """The batched phases with certificates faulted from scan 5 on:
    ``swapped`` exchanges instances 1 and 2's, ``scaled`` puts every one
    of ``instance``'s 1% off."""
    from fl_slam_tpu_torch import graphs

    def core(state, ctx, scan, cfg):
        new, ctx2, out = phases.core(state, ctx, scan, cfg)
        late = state.scan_seq >= 5
        certs = {}
        for k, v in out.certs.items():
            if fault == "swapped":
                w = v.clone()
                w[1], w[2] = v[2], v[1]
            else:
                w = v.clone()
                w[instance] = v[instance] * 1.01
            at = late.reshape((-1,) + (1,) * (v.dim() - 1))
            certs[k] = torch.where(at, w, v)
        return new, ctx2, out._replace(certs=certs)

    return graphs.Phases(phases.begin, core, phases.end)


@pytest.mark.parametrize("fault,instance", [("swapped", 1), ("scaled", 1),
                                            ("scaled", 2)])
def test_certificates_faulted_in_one_instance_are_not_correct(
        fault, instance, monkeypatch):
    """The check reads every instance's certificates: exchanged between
    two instances, or off in one, they fail ``cert_gap``."""
    from fl_slam_tpu_torch.parallel import replicas
    lim = harness.load_json(harness.HERE / "workloads"
                            / f"{CELL}.json")["limits"]["cert_gap"]
    monkeypatch.setattr(replicas, "PHASES", _certs_faulted(
        replicas.PHASES, fault, instance))
    res = _run()
    assert res["correct"] is False
    assert res["check"]["cert_gap"]["value"] > lim


def test_the_drive_takes_its_instances_from_the_configuration():
    cell = harness.build_cell(CELL, 5, None)
    drive = harness.load_module(harness.HERE / "drives" / "batched.py",
                                "benchmarks.drives.batched").Drive(cell)
    assert drive.B == 8 and cell.cfg.insert_page_dense
    import numpy as np
    for p in range(3):
        for a in range(0, 200, 50):
            drive.outs.append((p, a, np.zeros((8, 50, 6)), {}))
    pairs = drive.compared()
    whole = [k for k, n in pairs if n == 200]
    assert len(whole) == 1 and len(pairs) == 8
    (p, b), = whole
    assert sorted(i for (q, i), n in pairs if n == 50) == sorted(
        set(range(8)) - {b})
