"""The plain reference: it imports nothing of the program or of JAX, its
configurations are the program's, and it replays as the port's plain path
does (CPU, small sizes)."""

import ast
import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import harness, program
from benchmarks.reference import replay as ref
from benchmarks.traffic import synthetic

FORBIDDEN = ("fl_slam_tpu_torch", "fl_slam_tpu", "jax", "jaxlib", "flax")
SMALL_TPU = dict(k_hyp=1, view_page=64, view_refresh_every=5,
                 merge_at_chunk=True, approx_topk=True, select_bf16=True,
                 surfel_moment_kernel=True, fuse_moment_kernel=True,
                 belief_kernel=True, camera_fuse_geom_scale=0.0)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((harness.HERE / "reference").rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            top = name.split(".", 1)[0]
            assert top not in FORBIDDEN, (f, name)
            assert top != "benchmarks", (f, name)


@pytest.mark.parametrize("preset", ["tpu", "default", "small"])
def test_reference_presets_are_the_programs(preset):
    a = program.config(preset, {})
    b = ref.config(preset, {})
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa == fb


def _data(n, seed=5):
    cfg = program.config("small", {})
    return synthetic.simulate(program.sizes(cfg), n_scans=n, seed=seed,
                              odom_drift_vel_scale=1.03,
                              odom_drift_yaw_rate=0.01)


@pytest.mark.parametrize("over", [SMALL_TPU, {"k_hyp": 2},
                                  dict(SMALL_TPU, belief_kernel=False)],
                         ids=["kernels", "bank", "op_by_op"])
def test_reference_replay_is_the_plain_path(over):
    from fl_slam_tpu_torch import pipeline
    cpu = torch.device("cpu")
    d = _data(10)
    cfg = program.config("small", over)
    t0 = float(d.gt_stamps[0]) - 0.1
    st = pipeline.init_state(cfg, t0=t0, device=cpu)
    _, out = pipeline.replay(st, program.stage(d.scans, cfg, cpu), cfg,
                             device=cpu)
    poses, certs = ref.replay_segments(ref.config("small", over), d.scans,
                                       10, t0, 10, cpu)
    assert np.abs(out.pose.numpy() - poses).max() < 1e-9
    prog_certs = program.segment_cert_table([out.certs])
    shared = set(prog_certs) & set(certs)
    assert len(shared) > 50
    for k in shared:
        np.testing.assert_allclose(prog_certs[k], certs[k], rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def test_reference_steps_are_process_scan():
    from fl_slam_tpu_torch import pipeline
    cpu = torch.device("cpu")
    d = _data(4)
    cfg = program.config("small", {"k_hyp": 2})
    t0 = float(d.gt_stamps[0]) - 0.1
    st = pipeline.init_state(cfg, t0=t0, device=cpu)
    scans = program.stage(d.scans, cfg, cpu)
    step = pipeline.make_step(cfg, device=cpu)
    got = []
    for i in range(4):
        st, out = step(st, pipeline.ScanInput(*[f[i] for f in scans]))
        got.append(out.pose.numpy())
    poses, _ = ref.replay_steps(ref.config("small", {"k_hyp": 2}), d.scans,
                                t0, 4, cpu)
    assert np.abs(np.stack(got) - poses).max() < 1e-12
