"""``fl_slam_tpu_torch.graphs``: the pipeline's three chunk phases as CUDA
graph replays on the card, eager elsewhere.

On the CPU the phases stay eager and count ``graph.eager`` by reason
(``cpu``; ``functorch`` under the batched replay's ``vmap``), and the results
are those of the phases called by hand. The lineage's buffers, donation,
output packing, key and launch counters are held bit for bit against the
eager phases on the CPU too, with ``_Rerun`` standing for the capture: it
captures nothing (the buffers it wrote are put back) and replays by running
the phase again into the captured outputs.

On the card, graph replays and eager runs agree bit for bit (a 50-scan
``replay_segments`` at ``GCConfig.tpu()``, 20 ``make_step`` calls at
``GCConfig.tpu()`` and at ``GCConfig()``), two lineages from fresh states
give the eager results, a returned scan's certificates outlive later calls,
each phase is captured once a key, and the profiler's launches of each port
kernel agree with the port's counters over graph replays. The file imports
no JAX: ``python3 -m pytest --noconftest -q tests/test_torch_graphs.py``.
"""

from collections import namedtuple

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fl_slam_tpu_torch import graphs, profile_replay, tracing
from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.io import kimera, rosbag, synthetic
from fl_slam_tpu_torch.parallel import replicas
from fl_slam_tpu_torch.structures import atlas_kernels

CPU = [ProfilerActivity.CPU]
TINY = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
            belief_kernel=True)
BANK = dict(k_hyp=2)             # the bank under vmap, per-slot view, R = 1
DRIFT = dict(odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    graphs.clear()
    yield
    tracing.reset()
    graphs.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 -m pytest "
                    "--noconftest tests/test_torch_graphs.py)")
    return torch.device("cuda")


class _Rerun:
    """A graph on the CPU: replays by running the captured phase again,
    into the outputs the capture returned."""

    def __init__(self, body, outs):
        self.body, self.outs = body, outs

    def replay(self):
        kept = graphs._launch_counts()      # a replay runs no Python
        outs = self.body() or ()
        for counts, was in zip(graphs._LAUNCHES, kept):
            counts.update(was)
        for a, b in zip(self.outs, outs):
            a.copy_(b)


def _rerun_capture(lineage, body):
    bufs = lineage.S + (lineage.C or [])
    kept = [t.clone() for t in bufs]
    outs = tuple(body() or ())
    for t, k in zip(bufs, kept):          # a capture executes nothing
        t.copy_(k)
    return graphs._Graph(_Rerun(body, outs), outs, ())


@pytest.fixture
def rerun(monkeypatch):
    """The graph path on the CPU, ``_Rerun`` standing for the capture."""
    monkeypatch.setattr(graphs, "_capture", _rerun_capture)
    monkeypatch.setattr(graphs, "eager_reason", lambda dev: None)


def _eager(monkeypatch):
    monkeypatch.setattr(graphs, "eager_reason", lambda dev: "cpu")


def _sequence(cfg, device, n, seed=3):
    ds = synthetic.simulate(cfg, n_scans=n, seed=seed, **DRIFT)
    return ds, synthetic.to_scan_inputs(ds, cfg, device=device)


def _fresh(cfg, ds, device):
    return tp.init_state(cfg, anchor0=ds.gt_poses[0],
                         t0=float(ds.gt_stamps[0]) - 0.1, device=device)


def _steps(cfg, ds, scans, device, n):
    step = tp.make_step(cfg, device=device)
    st, outs = _fresh(cfg, ds, device), []
    for i in range(n):
        st, out = step(st, tp._scan_at(scans, i))
        outs.append(out)
    return st, outs


def _replay(cfg, ds, scans, device, seg_len):
    T = scans.scan_start.shape[0]
    segs = [tp.ScanInput(*[f[a:a + seg_len] for f in scans])
            for a in range(0, T, seg_len)]
    return tp.replay_segments(_fresh(cfg, ds, device), segs, cfg,
                              device=device)


def _bits(t):
    """A tensor as its integer bit pattern (NaNs compare by their bits)."""
    t = t.detach()
    if t.dtype.is_floating_point:
        return t.view({4: torch.int32, 8: torch.int64,
                       2: torch.int16}[t.element_size()])
    return t


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


def _assert_trees_equal(a, b):
    sa, la = graphs.signature(a)
    sb, lb = graphs.signature(b)
    assert sa == sb
    for i, (x, y) in enumerate(zip(la, lb)):
        assert _same(x, y), i


def _assert_outputs_equal(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_outputs_equal(x, y)
        return
    assert _same(a.pose, b.pose) and _same(a.stamp, b.stamp)
    assert list(a.certs) == list(b.certs)
    for k in a.certs:
        assert _same(a.certs[k], b.certs[k]), k


def _by_hand(cfg, state, scans, R):
    """``replay`` as the three phases called in turn."""
    outs = []
    for c0 in range(0, scans.scan_start.shape[0], R):
        state, ctx = tp._chunk_begin(state, cfg, gamma_power=R)
        for i in range(c0, c0 + R):
            state, ctx, out = tp._scan_core(state, ctx,
                                            tp._scan_at(scans, i), cfg)
            outs.append(out)
        state = tp._chunk_end(state, ctx, cfg)
    return (tp.flush_slabs(state, "cpu"),
            tp._stack_outputs(outs, cfg, torch.device("cpu")))


# ---- the CPU: eager, counted, unchanged ------------------------------------
@pytest.mark.parametrize("drive", ["replay", "step"])
def test_cpu_stays_eager_and_counts_it(drive):
    cfg = GCConfig.small(**TINY)
    ds, scans = _sequence(cfg, "cpu", 5)
    with profile(activities=CPU):
        if drive == "replay":
            tp.replay(_fresh(cfg, ds, "cpu"), scans, cfg, device="cpu")
        else:
            _steps(cfg, ds, scans, "cpu", 2)
    calls = 5 + 2 if drive == "replay" else 2 * 3
    c = tracing.counters()
    assert c.get("graph.eager") == {"cpu": calls}
    assert "graph.replay" not in c and "graph.capture" not in c
    assert not graphs._lineages


def _batched_inputs(cfg, device, B, n, seed=3):
    """B drifting sequences of n scans (seeds seed ..), stacked on one
    device's shard, and a maker of their fresh states."""
    seqs = [_sequence(cfg, device, n, seed=seed + i) for i in range(B)]
    mesh = replicas.make_mesh([device])
    scans = replicas.shard_scan_inputs(
        replicas.stack_instances([s for _, s in seqs]), mesh)

    def fresh():
        return replicas.init_states_batched(
            cfg, B, anchors0=[ds.gt_poses[0] for ds, _ in seqs],
            t0=[float(ds.gt_stamps[0]) - 0.1 for ds, _ in seqs], mesh=mesh)

    return mesh, scans, fresh


@pytest.mark.parametrize("drive", ["batched_replay", "batched_step"])
def test_vmap_stays_eager_and_counts_functorch(drive):
    """The batched phases run outside any ``vmap``: on the CPU they stay
    eager for the device (``cpu``), each call counted once for its 2
    instances; the phases inside a ``vmap`` of the whole step stay eager as
    ``functorch``."""
    cfg = GCConfig.small(**dict(TINY, insert_page_dense=True))
    mesh, scans, fresh = _batched_inputs(cfg, "cpu", 2, 5)
    with profile(activities=CPU):
        if drive == "batched_replay":
            replicas.batched_replay(cfg, mesh)(fresh(), scans)
            calls = 5 + 2
        else:
            replicas.batched_step(cfg, mesh)(
                fresh(), (tp.ScanInput(*[f[:, 0] for f in scans[0]]),))
            calls = 3
        c = tracing.counters()
        tracing.reset()
        torch.func.vmap(lambda a, b: tp.process_scan(a, b, cfg, "cpu"))(
            fresh()[0], tp.ScanInput(*[f[:, 0] for f in scans[0]]))
    assert c.get("graph.eager") == {"cpu": calls}
    assert tracing.counters().get("graph.eager") == {"functorch": 3}
    assert not graphs._lineages


def test_cpu_replay_is_the_phases_by_hand():
    cfg = GCConfig.small(**TINY)
    ds, scans = _sequence(cfg, "cpu", 10)
    fs, out = tp.replay(_fresh(cfg, ds, "cpu"), scans, cfg, device="cpu")
    fs_h, out_h = _by_hand(cfg, _fresh(cfg, ds, "cpu"), scans, 5)
    _assert_outputs_equal(out, out_h)
    _assert_trees_equal(fs, fs_h)


# ---- the lineage on the CPU, with _Rerun for the capture -------------------
@pytest.mark.parametrize("case", ["tiny_replay", "tiny_step", "bank_step"])
def test_lineage_matches_eager_bit_for_bit(case, monkeypatch):
    cfg = GCConfig.small(**(BANK if case == "bank_step" else TINY))
    ds, scans = _sequence(cfg, "cpu", 10)

    def run():
        if case == "tiny_replay":
            return _replay(cfg, ds, scans, "cpu", 5)
        st, outs = _steps(cfg, ds, scans, "cpu", 4)
        return st, outs

    _eager(monkeypatch)
    st_e, out_e = run()
    monkeypatch.setattr(graphs, "_capture", _rerun_capture)
    monkeypatch.setattr(graphs, "eager_reason", lambda dev: None)
    st_g, out_g = run()
    assert len(graphs._lineages) == 1
    (lin,) = graphs._lineages.values()
    assert lin.graphs                     # the calls replayed
    _assert_outputs_equal(out_e, out_g)
    _assert_trees_equal(st_e, st_g)


def test_two_lineages_from_fresh_states(rerun, monkeypatch):
    cfg = GCConfig.small(**TINY)
    (ds_a, sc_a), (ds_b, sc_b) = (_sequence(cfg, "cpu", 10, seed=s)
                                  for s in (3, 4))
    a = _replay(cfg, ds_a, sc_a, "cpu", 5)[1]
    b = _replay(cfg, ds_b, sc_b, "cpu", 5)[1]
    assert len(graphs._lineages) == 1     # the second copied in its state
    _eager(monkeypatch)
    _assert_outputs_equal(a, _replay(cfg, ds_a, sc_a, "cpu", 5)[1])
    _assert_outputs_equal(b, _replay(cfg, ds_b, sc_b, "cpu", 5)[1])


def test_returned_outputs_outlive_later_calls(rerun):
    cfg = GCConfig.small(**TINY)
    ds, scans = _sequence(cfg, "cpu", 6)
    step = tp.make_step(cfg, device="cpu")
    st = _fresh(cfg, ds, "cpu")
    outs, kept = [], []
    for i in range(6):
        st, out = step(st, tp._scan_at(scans, i))
        outs.append(out)
        kept.append((out.pose.clone(), {k: v.clone()
                                        for k, v in out.certs.items()}))
    for out, (pose, certs) in zip(outs, kept):
        assert _same(out.pose, pose)
        for k, v in certs.items():
            assert _same(out.certs[k], v), k
    assert not _same(outs[0].pose, outs[-1].pose)


def test_each_phase_is_captured_once_a_key(rerun):
    cfg = GCConfig.small(**TINY)
    ds, scans = _sequence(cfg, "cpu", 10)
    with profile(activities=CPU):
        _replay(cfg, ds, scans, "cpu", 5)
        first = tracing.counters()
        tracing.reset()
        _replay(cfg, ds, scans, "cpu", 5)
        second = tracing.counters()
    assert first["graph.capture"] == {"chunk_begin": 1, "scan_core": 1,
                                      "chunk_end": 1}
    assert first["graph.replay"] == {"chunk_begin": 1, "scan_core": 9,
                                     "chunk_end": 1}
    assert "graph.capture" not in second and "graph.eager" not in second
    assert second["graph.replay"] == {"chunk_begin": 2, "scan_core": 10,
                                      "chunk_end": 2}


@pytest.mark.parametrize("drive", ["batched_replay", "batched_step"])
def test_batched_lineage_matches_eager_bit_for_bit(rerun, drive,
                                                   monkeypatch):
    """The batched phases of 3 instances through one lineage: each phase
    call a graph replay after its capture, counted once for all its
    instances, the outputs and states the eager batched run's."""
    cfg = GCConfig.small(**dict(TINY, insert_page_dense=True))
    mesh, scans, fresh = _batched_inputs(cfg, "cpu", 3, 10)

    def run():
        if drive == "batched_replay":
            (st,), (out,) = replicas.batched_replay(cfg, mesh)(fresh(),
                                                               scans)
            return st, out
        st, outs = fresh(), []
        step = replicas.batched_step(cfg, mesh)
        for i in range(3):
            st, (out,) = step(st, (tp._scan_at(scans[0], i, True),))
            outs.append(out)
        return replicas.flush_states_batched(st, mesh)[0], outs

    st_g, out_g = run()                     # the warm-ups and captures
    with profile(activities=CPU):
        st_g, out_g = run()
    c = tracing.counters()
    calls = 10 + 2 * 2 if drive == "batched_replay" else 3 * 3
    assert sum(c["graph.replay"].values()) == calls
    assert "graph.eager" not in c and "graph.capture" not in c
    assert len(graphs._lineages) == 1
    _eager(monkeypatch)
    st_e, out_e = run()
    _assert_outputs_equal(out_e, out_g)
    _assert_trees_equal(st_e, st_g)


def _fallback_phases():
    """Stand-in batched phases whose ``vmap`` meets a fallback (an
    in-place scatter of a batched tensor) in ``core``."""
    def begin(state, cfg, gamma_power=1):
        return state, {"v": state.x}

    def core(state, ctx, scan, cfg):
        def one(x):
            return x.clone().scatter_(0, torch.zeros(1, dtype=torch.long),
                                      x)
        with tracing.vmap_fallbacks("replicas.fallback"):
            x = torch.func.vmap(one)(state.x)
        return state._replace(x=x + scan.y.sum()), ctx, tp.ScanOutput(
            pose=x[:, :2], stamp=scan.y[:, 0], certs={})

    def end(state, ctx, cfg):
        return state

    return graphs.Phases(begin, core, end)


def test_replays_credit_the_fallbacks_of_their_capture(rerun, monkeypatch):
    """A graph replay runs no Python: each replay credits the fallbacks its
    capture met, counted there whether or not a profiler ran, so a traced
    replay counts what an eager call would."""
    kept = _Rerun.replay

    def quiet(self):                        # a replay runs no Python
        with tracing.recording():
            was = tracing.counters()
            kept(self)
            tracing.reset()
            for name, keys in was.items():
                for k, n in keys.items():
                    tracing.count(name, k, n)

    monkeypatch.setattr(_Rerun, "replay", quiet)
    fns, dev = _fallback_phases(), torch.device("cpu")
    cfg = GCConfig.small(**TINY)
    st = _St(torch.zeros(2, 3, dtype=torch.float64))
    sc = _Sc(torch.ones(2, 4, dtype=torch.float64))

    def chunk(state):
        lin = graphs.phases(fns, state, sc, cfg, dev)
        state, ctx = lin.begin(state, 1)
        for _ in range(3):
            state, ctx, _ = lin.core(state, ctx, sc)
        return lin.end(state, ctx)

    st = chunk(st)                         # warm-up and capture, untraced
    assert not tracing.counters()
    with profile(activities=CPU):
        chunk(st)
    c = tracing.counters()
    assert c["graph.replay"]["scan_core"] == 3
    assert c["replicas.fallback"] == {"aten::scatter_.src": 3}
    _eager(monkeypatch)
    tracing.reset()
    with profile(activities=CPU):
        chunk(st)
    assert tracing.counters()["replicas.fallback"] == {
        "aten::scatter_.src": 3}


# ---- the key, on stand-in phases -------------------------------------------
def _toy_phases():
    def begin(state, cfg, gamma_power=1):
        return state._replace(x=state.x * (1 + gamma_power)), {"v": state.x}

    def core(state, ctx, scan, cfg):
        atlas_kernels.launches["exchange_ff"] += 2
        st = state._replace(x=state.x + scan.y.sum())
        return st, {"v": ctx["v"] + 1}, tp.ScanOutput(
            pose=st.x[:2], stamp=scan.y[0], certs={"n": ctx["v"][0]})

    def end(state, ctx, cfg):
        return state._replace(x=state.x - ctx["v"])

    return graphs.Phases(begin, core, end)


_St = namedtuple("_St", "x")
_Sc = namedtuple("_Sc", "y")


def _toy(dtype=torch.float64, n=3):
    return _St(torch.arange(n, dtype=dtype)), _Sc(torch.ones(4, dtype=dtype))


@pytest.mark.parametrize("change", ["none", "config", "shape", "dtype",
                                    "scan_shape"])
def test_the_key_separates_configuration_shapes_and_dtypes(rerun, change):
    fns, dev = _toy_phases(), torch.device("cpu")
    cfg = GCConfig.small(**TINY)
    st, sc = _toy()
    lin = graphs.phases(fns, st, sc, cfg, dev)
    other = {"none": (fns, st, sc, GCConfig.small(**TINY)),
             "config": (fns, st, sc, GCConfig.small()),
             "shape": (fns, _toy(n=4)[0], sc, cfg),
             "dtype": (fns, _toy(torch.float32)[0], sc, cfg),
             "scan_shape": (fns, st, sc._replace(y=torch.ones(5,
                            dtype=torch.float64)), cfg)}[change]
    lin2 = graphs.phases(*other, dev)
    assert (lin2 is lin) == (change == "none")


def test_the_key_separates_gamma_power_and_replays_count_launches(rerun):
    fns, dev = _toy_phases(), torch.device("cpu")
    cfg = GCConfig.small(**TINY)
    st, sc = _toy()
    before = atlas_kernels.launches["exchange_ff"]
    ref = graphs._Eager(fns, cfg, "cpu")
    lin = graphs.phases(fns, st, sc, cfg, dev)
    x_ref, x_lin = _toy()[0], st
    for R in (2, 1, 2, 1):
        outs = []
        for ph in (ref, lin):
            s = x_ref if ph is ref else x_lin
            s, ctx = ph.begin(s, R)
            for _ in range(R):
                s, ctx, out = ph.core(s, ctx, sc)
            outs.append((ph.end(s, ctx), out))
        (x_ref, o_ref), (x_lin, o_lin) = outs
        _assert_trees_equal(x_ref, x_lin)
        _assert_outputs_equal(o_ref, o_lin)
    assert set(lin.graphs) == {("chunk_begin", 2), ("chunk_begin", 1),
                               "scan_core", "chunk_end"}
    # 6 scans through each runner: the warm-up and the replays count 2
    # launches a scan each; the capture's own increments are taken back.
    assert atlas_kernels.launches["exchange_ff"] - before == 2 * 6 * 2


# ---- the card --------------------------------------------------------------
@pytest.mark.parametrize("case", ["tpu_replay", "tpu_step", "default_step"])
def test_graphs_match_eager_on_the_card(cuda, case, monkeypatch):
    cfg = GCConfig() if case == "default_step" else GCConfig.tpu()
    ds, scans = _sequence(cfg, cuda, 50 if case == "tpu_replay" else 20)

    def run():
        if case == "tpu_replay":
            return _replay(cfg, ds, scans, cuda, 10)
        return _steps(cfg, ds, scans, cuda, 20)

    _eager(monkeypatch)
    st_e, out_e = run()
    monkeypatch.undo()
    with profile(activities=CPU):
        st_g, out_g = run()
    c = tracing.counters()
    assert "graph.eager" not in c and c["graph.replay"]
    _assert_outputs_equal(out_e, out_g)
    _assert_trees_equal(st_e, st_g)


def test_two_lineages_and_kept_outputs_on_the_card(cuda, monkeypatch):
    cfg = GCConfig.tpu()
    (ds_a, sc_a), (ds_b, sc_b) = (_sequence(cfg, cuda, 20, seed=s)
                                  for s in (3, 4))
    a_st, a = _steps(cfg, ds_a, sc_a, cuda, 20)
    a_kept = [(o.pose.clone(), {k: v.clone() for k, v in o.certs.items()})
              for o in a]
    b = _steps(cfg, ds_b, sc_b, cuda, 20)[1]
    for out, (pose, certs) in zip(a, a_kept):   # outlived lineage b
        assert _same(out.pose, pose)
        for k, v in certs.items():
            assert _same(out.certs[k], v), k
    _eager(monkeypatch)
    _assert_outputs_equal(a, _steps(cfg, ds_a, sc_a, cuda, 20)[1])
    _assert_outputs_equal(b, _steps(cfg, ds_b, sc_b, cuda, 20)[1])


def test_capture_once_and_counters_reconcile_on_the_card(cuda):
    cfg = GCConfig.tpu()
    ds, scans = _sequence(cfg, cuda, 20)
    with profile(activities=CPU):
        _replay(cfg, ds, scans, cuda, 10)
    first = tracing.counters()
    assert first["graph.capture"] == {"chunk_begin": 1, "scan_core": 1,
                                      "chunk_end": 1}
    torch.cuda.synchronize()
    tracing.reset()
    before = {m: dict(c) for m, c in profile_replay._counters().items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _replay(cfg, ds, scans, cuda, 10)
        torch.cuda.synchronize()
        profile_replay._trailer()
    after = {m: dict(c) for m, c in profile_replay._counters().items()}
    c = tracing.counters()
    assert "graph.capture" not in c
    assert c["graph.replay"] == {"chunk_begin": 2, "scan_core": 20,
                                 "chunk_end": 2}
    counts = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            counts[e.name()] = counts.get(e.name(), 0) + 1
    diff = {m: {k: after[m][k] - before[m].get(k, 0) for k in after[m]}
            for m in after}
    rows = profile_replay.reconcile(counts.items(), diff)
    assert rows and all(r["agree"] for r in rows), rows
    assert {r["name"] for r in rows} >= {"pe_kernel", "tail_kernel",
                                         "sinkhorn_cluster", "exchange_pass"}


def test_capture_beside_the_staging_thread_on_the_card(cuda, tmp_path,
                                                      monkeypatch):
    """A bag streamed in segments: the first segment's phases are captured
    while the stager's thread stages the next one (pinning its second
    buffer); the poses and certificates are the eager run's bit for bit."""
    cfg = GCConfig.tpu()
    bag_dir, _ = kimera.make_kimera_fixture_bag(str(tmp_path / "bag"),
                                                n_scans=40, seed=0)

    def run():
        st = tp.init_state(cfg, t0=rosbag.TIME_REBASE_MARGIN_S - 0.1,
                           device=cuda)
        stager = rosbag.StreamingStager(bag_dir, kimera.KIMERA_TOPICS, cfg,
                                        10, device=cuda)
        return tp.replay_segments(st, iter(stager), cfg, device=cuda)[1]

    _eager(monkeypatch)
    eager = run()
    monkeypatch.undo()
    _assert_outputs_equal(eager, run())


def test_batched_graphs_match_eager_on_the_card(cuda, monkeypatch):
    """``GCConfig.tpu()`` at B = 8 over 2 chunks: the batched phases'
    graphs, at their capture and at their replay, give the eager batched
    replay's poses, certificates and final state bit for bit; every
    batched phase call of the replay is one graph replay for 8 instances."""
    cfg = GCConfig.tpu()
    mesh, scans, fresh = _batched_inputs(cfg, cuda, 8, 20)
    run = replicas.batched_replay(cfg, mesh)
    _eager(monkeypatch)
    (st_e,), (out_e,) = run(fresh(), scans)
    monkeypatch.undo()
    (st_c,), (out_c,) = run(fresh(), scans)
    _assert_outputs_equal(out_e, out_c)
    _assert_trees_equal(st_e, st_c)
    with profile(activities=CPU):
        (st_g,), (out_g,) = run(fresh(), scans)
    c = tracing.counters()
    assert c["graph.replay"] == {"chunk_begin": 2, "scan_core": 20,
                                 "chunk_end": 2}
    assert "graph.eager" not in c and "graph.capture" not in c
    _assert_outputs_equal(out_e, out_g)
    _assert_trees_equal(st_e, st_g)


def test_batched_counters_reconcile_on_the_card(cuda):
    """Over graph replays of the batched phases (B = 8), the profiler's
    launches of each port kernel agree with the port's counters: one
    batched launch a call for all instances."""
    cfg = GCConfig.tpu()
    mesh, scans, fresh = _batched_inputs(cfg, cuda, 8, 20)
    run = replicas.batched_replay(cfg, mesh)
    run(fresh(), scans)
    torch.cuda.synchronize()
    states = fresh()
    before = {m: dict(c) for m, c in profile_replay._counters().items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(states, scans)
        torch.cuda.synchronize()
        profile_replay._trailer()
    after = {m: dict(c) for m, c in profile_replay._counters().items()}
    counts = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            counts[e.name()] = counts.get(e.name(), 0) + 1
    diff = {m: {k: after[m][k] - before[m].get(k, 0) for k in after[m]}
            for m in after}
    rows = profile_replay.reconcile(counts.items(), diff)
    assert rows and all(r["agree"] for r in rows), rows
    by = {r["name"]: r["port"] for r in rows}
    assert by["sinkhorn_cluster"] == 20 and by["pe_kernel"] == 20
    assert by["exchange_pass"] == 2
