"""The Python side of the port's kernel launches, on the CPU: the device
guard every launch runs under (a mesh of two CUDA devices, faked), the
entry points' ctypes types set once at load, the reconciliation of
``profile_replay``'s profiler counts with the port's launch counters, the
launch plans of K3 (the cluster Sinkhorn), K4 (the sorted segment-sum) and
K9 (the candidate selection), K6's launch arguments, K11's op on the CPU
(the plain chain, alone and under ``vmap``) and its source's tables, and
the plain versions
against the JAX package on the edge cases the redesigned kernels are held
to on the card.
"""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fl_slam_tpu.ops import assoc_kernels as j_assoc
from fl_slam_tpu_torch import cuda_build, profile_replay
from fl_slam_tpu_torch.core.linalg import jacobi_rounds
from fl_slam_tpu_torch.ops import (assoc_kernels, belief_kernels,
                                   surfel_kernels)
from fl_slam_tpu_torch.ops import fusion as fusion_ops
from fl_slam_tpu_torch.ops import imu as imu_ops
from fl_slam_tpu_torch.ops import imu_window_cases
from fl_slam_tpu_torch.parallel import replicas
from fl_slam_tpu_torch.structures import atlas_kernels

MESH = (torch.device("cuda", 0), torch.device("cuda", 1))


class _FakeCuda:
    """Stands in for ``torch.cuda.device``, ``current_device`` and
    ``torch._C._cuda_getCurrentRawStream``: a stack of current devices, and
    a raw stream handle naming its device."""

    def __init__(self):
        self.current = [0]

    def current_device(self):
        return self.current[-1]

    def device(self, dev):
        fake = self

        class _Guard:
            def __enter__(self):
                fake.current.append(torch.device(dev).index)

            def __exit__(self, *exc):
                fake.current.pop()

        return _Guard()

    def raw_stream(self, index):
        return 1000 + index


class _FakeLib:
    def fl_error_string(self, rc):
        return b"fake error"


@pytest.fixture
def fake_cuda(monkeypatch):
    fake = _FakeCuda()
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_device", fake.current_device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        fake.raw_stream, raising=False)
    return fake


def test_launch_runs_with_its_device_current(fake_cuda):
    seen = []

    def entry(*args):
        seen.append((fake_cuda.current[-1], args))
        return 0

    for dev in MESH:
        cuda_build.launch(_FakeLib(), entry, "k", dev, 7, 8)
    assert [s[0] for s in seen] == [0, 1]
    assert [s[1] for s in seen] == [(7, 8, 1000), (7, 8, 1001)]
    assert fake_cuda.current == [0]          # restored after each launch


def test_launch_raises_on_a_cuda_error(fake_cuda):
    with pytest.raises(RuntimeError, match="k: CUDA error 9 .fake error."):
        cuda_build.launch(_FakeLib(), lambda *a: 9, "k", MESH[1])
    assert fake_cuda.current == [0]


def test_each_shard_runs_with_its_device_current(fake_cuda):
    """A two-card mesh: every kernel launch inside a shard's program sees
    the shard's device as the current one."""
    seen = []

    def entry(*args):
        seen.append(fake_cuda.current[-1])
        return 0

    def program(state, scans, dev):
        cuda_build.launch(_FakeLib(), entry, "k", dev)    # a kernel
        seen.append(("shard", fake_cuda.current[-1]))
        return state + scans, scans

    states, outs = replicas._pairs(replicas._per_device(
        program, (1, 2), (10, 20), MESH))
    assert states == (11, 22) and outs == (10, 20)
    assert seen == [0, ("shard", 0), 1, ("shard", 1)]
    assert fake_cuda.current == [0]


def test_device_guard_is_a_no_op_for_the_cpu(fake_cuda):
    with cuda_build.device_guard(torch.device("cpu")):
        assert fake_cuda.current == [0]
    out = replicas._per_device(lambda x, dev: x * 2, (3,), ("cpu",))
    assert out == (6,)


@pytest.mark.parametrize("mesh,copied", [
    ((torch.device("cpu"),) * 2, False),
    ((MESH[0],) * 2, True)])
def test_shards_of_one_device_are_copied_only_out_of_graphs(fake_cuda, mesh,
                                                            copied):
    """Two shards on one CUDA device share its graph lineage's buffers, so
    their results are copied out; on the CPU there are no graphs to copy
    from."""
    kept = [torch.arange(3.0), torch.arange(4.0)]
    out = replicas._per_device(lambda i, dev: (kept[i], i), (0, 1), mesh)
    for i, (t, j) in enumerate(out):
        assert j == i and torch.equal(t, kept[i])
        assert (t is not kept[i]) == copied


def test_every_wrapper_launches_through_the_guard():
    """No module of the port calls a kernel's C entry point with a stream
    of its own: each goes through ``cuda_build.launch``."""
    pkg = Path(cuda_build.__file__).parent
    callers = []
    for path in sorted(pkg.rglob("*.py")):
        src = path.read_text()
        if path.name == "cuda_build.py":
            continue
        assert "current_stream" not in src, path
        assert "stream_ptr" not in src, path
        if "cuda_build.library(" in src:
            assert src.count("cuda_build.launch(") >= src.count(
                "cuda_build.library("), path
            callers.append(path.name)
    assert set(callers) >= {"assoc_kernels.py", "surfel_kernels.py",
                            "belief_kernels.py", "atlas_kernels.py",
                            "splat_kernels.py"}


# -- the entry points' ctypes types, set once when a library is loaded ----

class _Entry:
    argtypes = None
    restype = None


class _Lib:
    def __init__(self, names):
        for n in ("fl_error_string", *names):
            setattr(self, n, _Entry())


def test_every_entry_point_gets_its_types_at_load():
    codes = {"p": ctypes.c_void_p, "i": ctypes.c_int,
             "q": ctypes.c_longlong, "d": ctypes.c_double}
    for name in cuda_build.SOURCES:
        entries = cuda_build.ENTRY_POINTS[name]
        lib = cuda_build.bind(_Lib(entries), name)
        assert lib.fl_error_string.argtypes == [ctypes.c_int]
        for entry, sig in entries.items():
            fn = getattr(lib, entry)
            assert fn.argtypes == [codes[c] for c in sig] + [ctypes.c_void_p]
            assert fn.restype is ctypes.c_int
    assert set(cuda_build.ENTRY_POINTS) == set(cuda_build.SOURCES)


def _c_code(param: str) -> str:
    """The argument code of one C parameter declaration."""
    if "*" in param:
        return "p"
    words = param.split()[:-1]
    return {("int",): "i", ("long", "long"): "q",
            ("double",): "d"}[tuple(words)]


def _c_entry_points(src: str) -> dict:
    """extern "C" entry points of a source and their argument codes (the
    stream last, left out), through the FL_*_ENTRY macros too."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        params = [p.strip() for p in m.group(2).replace("\\", " ").split(",")]
        assert params[-1].split() == ["void*", "stream"], m.group(1)
        codes = "".join(_c_code(p) for p in params[:-1])
        name = m.group(1)
        if name == "NAME":
            macro = src[:m.start()].rsplit("#define ", 1)[1].split("(")[0]
            for inv in re.finditer(rf"^{macro}\((\w+),", src, re.M):
                out[inv.group(1)] = codes
        elif name != "fl_error_string":
            out[name] = codes
    return out


def test_entry_point_codes_match_the_c_declarations():
    for name in cuda_build.SOURCES:
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        declared = _c_entry_points(src)
        assert declared, name
        assert cuda_build.ENTRY_POINTS[name] == declared, name


def test_no_wrapper_sets_types_per_call():
    pkg = Path(cuda_build.__file__).parent
    for mod in ("ops/assoc_kernels.py", "ops/surfel_kernels.py",
                "ops/belief_kernels.py", "structures/atlas_kernels.py",
                "render/splat_kernels.py", "parallel/replicas.py"):
        src = (pkg / mod).read_text()
        assert ".argtypes" not in src and ".restype" not in src, mod


def test_launch_enters_the_guard_only_off_the_current_device(fake_cuda,
                                                             monkeypatch):
    entered = []
    real = fake_cuda.device

    def device(dev):
        entered.append(torch.device(dev).index)
        return real(dev)
    monkeypatch.setattr(torch.cuda, "device", device)
    for dev in (MESH[0], MESH[0], MESH[1]):
        cuda_build.launch(_FakeLib(), lambda *a: 0, "k", dev)
    assert entered == [1]


# -- profile_replay: the profiler's counts against the port's counters ----

def _zero_counters():
    return {"assoc_kernels": dict.fromkeys(assoc_kernels.launches, 0),
            "belief_kernels": dict.fromkeys(belief_kernels.launches, 0),
            "surfel_kernels": dict.fromkeys(surfel_kernels.launches, 0),
            "atlas_kernels": {"exchange_ff": 0, "exchange_ff_batched": 0,
                              "exchange": 0, "exchange_batched": 0,
                              "page_gather": 0, "page_writeback": 0}}


def _replay_events(n=20):
    """Profiler keys as torch.profiler names them, for n scans of the
    kernel-branch replay: K4 at two F (two template instances)."""
    ns = "void (anonymous namespace)::"
    return [(f"{ns}pe_kernel<float>(float const*, ...)", n),
            (f"{ns}tail_kernel<float>(...)", n),
            (f"{ns}sinkhorn_cluster<float, 8, 1>(...)", n),
            (f"{ns}moment_sort_reduce<float>(...)", 2 * n),
            (f"{ns}moment_gather<float>(...)", 2 * n),
            (f"{ns}exchange_pass<float>(...)", n // 10),
            ("void at::native::elementwise_kernel<128, 2>(...)", 999)]


def _replay_counters(n=20):
    c = _zero_counters()
    c["belief_kernels"].update(predict_evidence=n, scalar_tail=n)
    c["assoc_kernels"]["sinkhorn_piT"] = n
    c["surfel_kernels"].update(surfels=n, fuse=n)
    c["atlas_kernels"]["exchange_ff"] = n // 10
    return c


def test_reconcile_agrees_on_a_replay():
    rows = profile_replay.reconcile(_replay_events(), _replay_counters())
    assert {r["name"] for r in rows} == {
        "pe_kernel", "tail_kernel", "sinkhorn_cluster", "moment_sort_reduce",
        "moment_gather", "exchange_pass"}
    assert all(r["agree"] for r in rows)
    ex = [r for r in rows if r["name"] == "exchange_pass"][0]
    assert ex["profiler"] == ex["port"] == 2     # one launch per count


@pytest.mark.parametrize("where", ["profiler", "port"])
def test_reconcile_flags_a_lost_launch(where):
    events, counters = _replay_events(), _replay_counters()
    if where == "profiler":
        events[3] = (events[3][0], events[3][1] - 1)   # one K4 launch lost
    else:
        counters["surfel_kernels"]["fuse"] += 1
    rows = profile_replay.reconcile(events, counters)
    bad = [r["name"] for r in rows if not r["agree"]]
    assert bad == ["moment_sort_reduce"] if where == "profiler" else \
        bad == ["moment_sort_reduce", "moment_gather"]


def test_reconcile_counts_batched_launches_and_kernels_no_one_counted():
    c = _zero_counters()
    c["assoc_kernels"]["sinkhorn_piT_batched"] = 5
    c["atlas_kernels"].update(page_gather=5, page_writeback=5)
    events = [("void (anonymous namespace)::sinkhorn_cluster<float, 8, 1>()",
               5),
              ("void (anonymous namespace)::page_kernel<float, true>()", 5),
              ("void (anonymous namespace)::page_kernel<float, false>()", 5),
              ("void (anonymous namespace)::select_kernel<float>()", 2)]
    rows = {r["name"]: r for r in profile_replay.reconcile(events, c)}
    assert rows["sinkhorn_cluster"]["agree"] and rows["page_kernel"]["agree"]
    assert rows["select_kernel"] == {"name": "select_kernel", "profiler": 2,
                                     "port": 0, "agree": False}
    assert profile_replay.own_kernel("void foo<float>()") is None


def test_own_kernels_name_the_device_symbols_of_the_sources():
    src = "".join(p.read_text() for p in cuda_build.CSRC.glob("*.cu"))
    for k in profile_replay.OWN_KERNELS:
        assert f" {k}(" in src or f"\n{k}(" in src, k
    assert "moment_partial" not in src and "sinkhorn_kernel" not in src


# -- K4: the span and the scratch of the sorted segment-sum --------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("F", [11, 32, 64])
def test_moment_plan_span_fits_shared_memory_by_dtype_and_rows(F, itemsize):
    plan = surfel_kernels.moment_plan(F, 1 << 16, 5376, itemsize)
    assert plan["span"] == 256 and plan["spans"] == (1 << 16) // 256
    assert plan["smem_bytes"] == 256 * (F * itemsize + 16)
    assert plan["smem_bytes"] <= 227 * 1024 - 8 * 1024   # beside static


@pytest.mark.parametrize("F,N", [(11, 8192), (32, 12288), (32, 12289),
                                 (64, 77), (1, 1), (5, 0)])
def test_moment_plan_covers_the_ids_with_scratch_of_order_FN(F, N):
    for itemsize in (4, 8):
        plan = surfel_kernels.moment_plan(F, N, 8192, itemsize)
        S, Y = plan["span"], plan["spans"]
        assert S & (S - 1) == 0 and 32 <= S <= 256
        assert Y * S >= N and (Y - 1) * S < max(N, 1)
        assert S <= max(32, 2 * N)               # cut to the ids it has
        # Scratch: the spans' cells and sums, O(F N), and a first run per
        # span and 128-cell tile -- no (Y, F, C) block.
        FP = plan["features_padded"]
        assert FP >= F and FP * itemsize % 16 == 0 and FP - F < 16 // itemsize
        assert plan["tiles"] == 8192 // 128 + 1
        assert plan["scratch_bytes"] <= ((N + S) * (FP * itemsize + 4)
                                         + 4 * Y * plan["tiles"])


def test_moment_plan_refuses_rows_it_cannot_take():
    with pytest.raises(ValueError, match="payload rows"):
        surfel_kernels.moment_plan(65, 100, 10, 4)
    with pytest.raises(ValueError, match="payload rows"):
        surfel_kernels.moment_plan(0, 100, 10, 4)


# -- K3: the cluster, its threads and its refusals ------------------------

def test_sinkhorn_plan_at_the_production_shape():
    plan = assoc_kernels.sinkhorn_plan(8, 1536, 4)
    assert plan == {"cluster": 8, "threads": 192, "cols_per_thread": 1,
                    "cols_per_cta": 192, "k_max": 8, "max_n": 8192,
                    "smem_bytes": 48 * 8 * 4}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("K", [1, 8, 9, 16, 20, 32])
def test_sinkhorn_plan_holds_every_column(K, itemsize):
    """Every N up to the plan's limit gets enough threads. From K = 8 up,
    every shape the one-block kernel held in (K + 2) N words of shared
    memory fits; below, 8,192 columns (the one-block kernel held up to
    18,688 at K = 1 in f32)."""
    max_n = assoc_kernels.sinkhorn_plan(K, 1, itemsize)["max_n"]
    old_max = (227 * 1024 - 8 * 1024) // ((K + 2) * itemsize)
    assert max_n >= (old_max if K >= 8 else 8192)
    for N in (1, 5, 7, 8, 100, 1000, 1536, 1537, max_n - 1, max_n):
        plan = assoc_kernels.sinkhorn_plan(K, N, itemsize)
        T, cpt = plan["threads"], plan["cols_per_thread"]
        assert T % 32 == 0 and 32 <= T <= 256 and cpt in (1, 2, 4)
        assert plan["cluster"] == 8 and plan["cols_per_cta"] == -(-N // 8)
        assert T * cpt >= plan["cols_per_cta"]
        # potentials in registers: at most 64 32-bit words a thread
        assert plan["k_max"] * cpt * itemsize // 4 <= 64 or cpt == 1
        assert plan["k_max"] >= K and plan["smem_bytes"] <= 48 * 1024


@pytest.mark.parametrize("K,N,itemsize", [(33, 64, 4), (40, 64, 4),
                                          (0, 64, 4), (8, 8193, 4),
                                          (32, 2049, 8), (32, 4097, 4)])
def test_sinkhorn_plan_refuses_what_it_cannot_hold(K, N, itemsize):
    with pytest.raises(ValueError, match="shared memory"):
        assoc_kernels.sinkhorn_plan(K, N, itemsize)


# -- K9: every chunk scored once, every row picked by one warp -----------

@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("N,V", [(128, 128), (128, 256), (1536, 5376),
                                 (256, 16640), (1536, 7168)])
def test_select_plan_scores_every_chunk_once(N, V, B):
    for itemsize in (4, 8):
        plan = assoc_kernels.select_plan(N, V, 8, itemsize, B)
        C = plan["chunks"]
        assert C == V // 128 and plan["grid"] == (plan["units"], B)
        # Stage 1: block u, one warp, scores chunk u % C of row group u // C.
        seen = [divmod(u, C) for u in range(plan["grid"][0])]
        assert len(seen) == len(set(seen)) == plan["groups"] * C
        assert set(seen) == {(g, c) for g in range(plan["groups"])
                             for c in range(C)}
        assert plan["warps"] == 1 and plan["threads"] == 32
        # Every row in exactly one group, one lane's row of one warp.
        R = plan["rows_per_lane"]
        assert plan["rows_per_warp"] == 32 * R
        assert (plan["groups"] - 1) * 32 * R < N <= plan["groups"] * 32 * R
        # Stage 2: row r on warp r % 4 of block r // 4.
        assert plan["topk_grid"] == (-(-N // 4), B)
        assert plan["cluster"] <= 8
        assert all(b <= 232448 for b in plan["smem_bytes"])
        assert plan["lanes"] % 128 == 0
        assert 2 * C <= plan["lanes"] < 2 * C + 128
        assert plan["scratch_bytes"] == B * N * 2 * C * (itemsize + 4)


@pytest.mark.parametrize("itemsize,ctype", [(4, "float"), (8, "double")])
def test_select_plan_matches_the_kernel_layout(itemsize, ctype):
    """The plan's constants are those of ``csrc/select.cu``, which launches
    from the plan: its rows per lane, stage-2 warps and staged column
    stride, so a plan the kernel takes covers every row and chunk."""
    src = (cuda_build.CSRC / "select.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    quad = re.search(rf"struct Quad<{ctype}> {{\s*static constexpr int "
                     r"kPer = (\d+), kQuads = (\d+), kStride = (\d+);", src)
    per, quads, stride = map(int, quad.groups())
    assert per * quads == 16 and per * itemsize == 16
    N, V = 1000, 16640
    plan = assoc_kernels.select_plan(N, V, 8, itemsize)
    assert const("kChunk") == 128 and const("kFeat") == 16
    assert plan["rows_per_lane"] == const("kRowsPerLane")
    assert plan["topk_grid"][0] * const("kTopkWarps") >= N
    assert plan["smem_bytes"] == (128 * stride * itemsize, const(
        "kTopkWarps") * plan["lanes"] * (itemsize + 4))


@pytest.mark.parametrize("N,V,k,B", [(128, 200, 8, 1), (128, 0, 8, 1),
                                     (0, 128, 8, 1), (128, 128, 0, 1),
                                     (128, 128, 8, 0), (128, 128, 8, 65536),
                                     (128, 128 * 2500, 8, 1)])
def test_select_plan_refuses_what_it_cannot_take(N, V, k, B):
    with pytest.raises(ValueError, match="select_candidates"):
        assoc_kernels.select_plan(N, V, k, 8, B)


# -- K6: the launch arguments at the batched replay's shape --------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("odt", [torch.int32, torch.int64])
def test_page_launch_args_at_the_batched_shape(dtype, odt):
    B, CF, S, M, P = 8, 32, 7, 1024, 128
    ff = torch.zeros((B, CF, S * M), dtype=dtype)
    page = torch.zeros((B, CF, S * P), dtype=dtype)
    offs = (torch.arange(S) * M).to(odt).expand(B, S)    # shared: stride 0
    args = atlas_kernels.page_launch_args("k", ff, offs, page, P)
    assert args[1:3] == (int(odt == torch.int64), 0)
    assert args[0] == offs.data_ptr() and args[3:5] == (ff.data_ptr(),
                                                        page.data_ptr())
    assert args[5:] == (B, CF, S * M, S, P)
    per = (torch.arange(B * S).reshape(B, S) * 128).to(odt)
    args = atlas_kernels.page_launch_args("k", ff, per, page, P)
    assert args[2] == S                       # the instances' own offsets
    one = atlas_kernels.page_launch_args("k", ff[:1], per[:1], page[:1], P)
    assert one[2] == 0 and one[5] == 1


def test_page_launch_args_refuse_what_the_kernel_does_not_take():
    ff = torch.zeros((2, 4, 512))
    page = torch.zeros((2, 4, 256))
    offs = torch.zeros((2, 2), dtype=torch.int64)
    for bad in (dict(offs=offs.to(torch.int16)), dict(ff=ff.half()),
                dict(page=torch.zeros((2, 4, 128))),
                dict(ff=ff.transpose(1, 2).contiguous().transpose(1, 2)),
                dict(offs=torch.zeros((2, 4), dtype=torch.int64)[:, ::2])):
        kw = dict(ff=ff, offs=offs, page=page) | bad
        with pytest.raises(ValueError, match="k: "):
            atlas_kernels.page_launch_args("k", kw["ff"], kw["offs"],
                                           kw["page"], 128)


# -- K11: the pose block's conditioning, one op for one matrix or B -------

def _evidence(seed, batch=()):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((*batch, 22, 22), generator=g, dtype=torch.float64)
    L = X @ X.transpose(-1, -2)
    L[..., 0, 1] += 0.25                                 # not symmetric
    return L


@pytest.mark.parametrize("how", ["one", "vmap", "vmap_dim1", "nested",
                                 "float32"])
def test_pose6_op_on_the_cpu_is_the_plain_chain(how):
    """On the CPU, ``fusion_ops.pose6_conditioning`` goes through K11's op
    and equals the plain chain bit for bit, as that chain ran before the
    op: alone, under the bank's or the instances' ``vmap`` (the instance
    axis first or second), nested, and in f32."""
    plain = belief_kernels.pose6_conditioning_plain

    def chain(L):
        return plain(L, 1e-9)[1]

    def op(L):
        return fusion_ops.pose6_conditioning(L, 1e-9)

    vmap = torch.func.vmap
    before = dict(belief_kernels.launches)
    if how in ("one", "float32"):
        L = _evidence(1)
        L = L.float() if how == "float32" else L
        got, want = op(L), chain(L)
    elif how == "nested":
        L = _evidence(2, (2, 3))
        got, want = vmap(vmap(op))(L), vmap(vmap(chain))(L)
    else:
        dim = 1 if how == "vmap_dim1" else 0
        L = _evidence(3, (4,)).movedim(0, dim)
        got, want = vmap(op, dim)(L), vmap(chain, dim)(L)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert belief_kernels.launches == before           # nothing launched


def test_pose6_op_returns_the_clamped_eigenvalues_and_their_ratio():
    L = _evidence(4)
    lam, ratio = belief_kernels.pose6_cond(L, 1e-9)
    want = torch.linalg.eigvalsh(0.5 * (L[:6, :6] + L[:6, :6].T))
    torch.testing.assert_close(lam, want, rtol=1e-12, atol=0.0)
    assert torch.equal(ratio, lam[5] / lam[0])
    lam0, ratio0 = belief_kernels.pose6_cond(torch.zeros(22, 22), 1e-6)
    assert torch.equal(lam0, torch.full((6,), 1e-6)) and ratio0 == 1.0


@pytest.mark.parametrize("L,match", [
    (torch.zeros(5, 5), "shape"), (torch.zeros(22), "shape"),
    (torch.zeros(6, 7), "shape"), (torch.zeros(2, 22, 22), "shape"),
    (torch.zeros(22, 22, dtype=torch.int32), "dtype"),
    (torch.zeros(22, 22, dtype=torch.float16), "dtype"),
    (torch.zeros(22, 22, device="meta"), "device")])
def test_pose6_op_refuses_what_the_kernel_does_not_take(L, match):
    with pytest.raises(ValueError, match=match):
        belief_kernels.pose6_cond(L, 1e-9)


def _cu_table(name: str) -> list:
    """The integers of a ``constexpr int <name>[...] = {...};`` table of
    K11's source, in order."""
    src = (cuda_build.CSRC / "pose6_cond.cu").read_text()
    body = re.search(rf"{name}\[[^=]*=\s*\{{(.*?)\}};", src, re.S).group(1)
    return [int(v) for v in re.findall(r"\d+", body)]


def test_pose6_kernel_runs_the_plain_chains_schedule():
    flat = [v for rnd in jacobi_rounds(6) for pair in rnd for v in pair]
    assert _cu_table("kSchedule") == flat


def test_pose6_kernel_sorting_network_sorts_every_input():
    """K11's 6-element network, by the 0-1 principle: it sorts every input
    of zeros and ones, so it sorts every input."""
    net = _cu_table("kNetwork")
    pairs = list(zip(net[0::2], net[1::2]))
    assert len(pairs) == 12 and all(a < b for a, b in pairs)
    for bits in range(64):
        d = [bits >> k & 1 for k in range(6)]
        for a, b in pairs:
            if d[a] > d[b]:
                d[a], d[b] = d[b], d[a]
        assert d == sorted(d), bits


# -- K12: the IMU window, one op for one window or B ---------------------

_EPS = dict(eps_mass=imu_window_cases.EPS_MASS,
            eps_psd=imu_window_cases.EPS_PSD)


def _iw_operands(seed, dtype=torch.float64, M=512):
    return [t.to(dtype) for t in imu_window_cases.operands(seed, M=M)]


def _chain(stamps, gyro, accel, prev_t, start, end, sig_dt, gb, ab, grav, R):
    """The IMU window as ``pipeline._scan_core`` ran it before K12, function
    by function; {entry of the packed row: value}."""
    eps_mass, eps_psd = _EPS["eps_mass"], _EPS["eps_psd"]
    dt_std = torch.sqrt(torch.clamp(sig_dt, min=0.0))
    sigma_warp = torch.clamp(dt_std, 0.01, 0.05)
    imu_valid = (stamps > 0.0).to(stamps.dtype)
    w_int = imu_ops.smooth_window_weights(
        stamps, prev_t, start, sigma_warp) * imu_valid
    wm_scan, dtv_scan = imu_ops.window_interval_weights(
        stamps, start, end, sigma_warp)
    wm_int, dtv_int = imu_ops.window_interval_weights(
        stamps, prev_t, start, sigma_warp)
    pre = {"scan": imu_ops.preintegrate(stamps, gyro, accel, wm_scan, gb, ab,
                                        grav, R, dtv_scan),
           "int": imu_ops.preintegrate(stamps, gyro, accel, wm_int, gb, ab,
                                       grav, R, dtv_int)}
    dt_int = imu_ops.integration_time(stamps, prev_t, start)
    dt_imu = imu_ops.mean_sample_period(stamps)
    omega_avg = imu_ops.weighted_mean_rate(gyro, w_int, gb, eps_mass)
    cover = torch.clamp(dt_int / torch.clamp(pre["int"]["dt_eff_sum"],
                                             min=eps_mass), 1.0, 2.0)
    g = imu_ops.gravity_resultant(accel, gyro, w_int, ab, dt_imu, eps_mass)
    M2, m1, sw = imu_ops.accel_moments(accel, w_int, ab, eps_mass)
    out = {"sigma_warp": sigma_warp, "dt_int": dt_int, "dt_imu": dt_imu,
           "cover": cover,
           "motion.delta_rotvec": pre["int"]["delta_pose"][3:6] * cover,
           "motion.delta_p_body": pre["int"]["delta_p"] * cover * cover,
           "motion.delta_v_body": pre["int"]["delta_v"] * cover,
           "omega_avg": omega_avg,
           "dpsi_gyro": imu_ops.gyro_iw_suffstats(
               gyro, w_int, gb, omega_avg, dt_imu, eps_mass=eps_mass,
               eps_psd=eps_psd),
           "acc.M2": M2, "acc.m1": m1, "acc.sw": sw, "w_int": w_int}
    for w in ("scan", "int"):
        for k in ("delta_pose", "delta_v", "ess", "a_body_mean",
                  "dt_eff_sum"):
            out[f"{w}.{k}"] = pre[w][k]
    for k in ("xbar", "rbar", "ess_w", "ess_raw", "transport_sigma",
              "rel_mean"):
        out[f"grav.{k}"] = g[k]
    return out


def _op(*ins):
    return belief_kernels.imu_window(*ins, **_EPS)


_SHARED = (None, None, None, 0, 0, 0, 0, 0, 0, None, 0)   # the bank's view


@pytest.mark.parametrize("how", ["one", "float32", "m64", "vmap",
                                 "vmap_shared", "vmap_dim1", "nested"])
def test_imu_window_op_on_the_cpu_is_the_plain_chain(how):
    """On the CPU, K12's op (``belief_kernels.imu_window``) runs the chain
    it replaced bit for bit, entry by entry: alone (f64, f32, M = 64),
    under ``vmap`` with every operand batched, with the window and gravity
    shared, with the instance axis second, and nested."""
    vmap = torch.func.vmap
    before = dict(belief_kernels.launches)
    if how in ("one", "float32", "m64"):
        dt = torch.float32 if how == "float32" else torch.float64
        ins = _iw_operands(1, dt, M=64 if how == "m64" else 512)
        got, want = _op(*ins), _chain(*ins)
    else:
        sets = [_iw_operands(s) for s in range(2, 6)]
        ins = [torch.stack(ts) for ts in zip(*sets)]
        dims = 0
        if how == "vmap_shared":
            dims = _SHARED
            ins = [t[0] if d is None else t for t, d in zip(ins, dims)]
        elif how == "vmap_dim1":
            dims = tuple(1 if t.dim() > 1 else 0 for t in ins)
            ins = [t.movedim(0, 1) if d else t for t, d in zip(ins, dims)]
        elif how == "nested":
            ins = [t.reshape(2, 2, *t.shape[1:]) for t in ins]
        if how == "nested":
            got, want = vmap(vmap(_op))(*ins), vmap(vmap(_chain))(*ins)
        else:
            got = vmap(_op, in_dims=dims)(*ins)
            want = vmap(_chain, in_dims=dims)(*ins)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert belief_kernels.launches == before           # nothing launched


def _iw_bad(k, t):
    ins = _iw_operands(7)
    ins[k] = t
    return ins


@pytest.mark.parametrize("ins,match", [
    (_iw_bad(0, torch.zeros(512, dtype=torch.int32)), "dtype"),
    (_iw_bad(0, torch.zeros(512, dtype=torch.float16)), "dtype"),
    (_iw_bad(1, torch.zeros(512, 3, dtype=torch.float32)), "operand 1"),
    (_iw_bad(0, torch.zeros(512, 1, dtype=torch.float64)), "shape"),
    (_iw_bad(0, torch.ones(1, dtype=torch.float64)), "shape"),
    (_iw_bad(0, torch.ones(1025, dtype=torch.float64)), "shape"),
    (_iw_bad(2, torch.zeros(512, 4, dtype=torch.float64)), "operand 2"),
    (_iw_bad(10, torch.eye(4, dtype=torch.float64)), "operand 10"),
    (_iw_bad(3, torch.zeros(1, dtype=torch.float64)), "operand 3"),
    ([t.to("meta") for t in _iw_operands(7)], "device")])
def test_imu_window_op_refuses_what_the_kernel_does_not_take(ins, match):
    with pytest.raises(ValueError, match=match):
        _op(*ins)


def test_imu_window_kernel_writes_the_twins_packed_row():
    """K12's output offsets (``constexpr int k...`` in its source) are the
    positions of the twin's entries, and its largest window is the
    wrapper's."""
    src = (cuda_build.CSRC / "imu_window.cu").read_text()
    const = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int k(\w+) = (\d+);", src)}
    where = {name: sl.start for name, sl in imu_window_cases.entries(1)}
    names = {"SigmaWarp": "sigma_warp", "DtInt": "dt_int",
             "DtImu": "dt_imu", "Cover": "cover",
             "PreScan": "scan.delta_pose[:3]",
             "PreInt": "int.delta_pose[:3]",
             "Motion": "motion.delta_rotvec", "OmegaAvg": "omega_avg",
             "DpsiGyro": "dpsi_gyro", "GravXbar": "grav.xbar",
             "GravRbar": "grav.rbar", "GravEssW": "grav.ess_w",
             "GravEssRaw": "grav.ess_raw", "GravSigma": "grav.transport_sigma",
             "GravRelMean": "grav.rel_mean", "AccM2": "acc.M2",
             "AccM1": "acc.m1", "AccSw": "acc.sw", "Header": "w_int"}
    for k, name in names.items():
        assert const[k] == where[name], k
    assert const["Header"] == imu_ops.IMU_WINDOW_HEADER_LEN == 74
    assert const["PreInt"] - const["PreScan"] == 14
    assert "kMaxM = kMaxThreads * kMaxItems" in src
    assert const["MaxThreads"] * const["MaxItems"] == \
        belief_kernels.IMU_WINDOW_MAX_M


@pytest.mark.parametrize("case", ("synthetic",)
                         + imu_window_cases.EDGE_CASES)
def test_imu_window_tolerance_holds_the_twin_and_refuses_a_fault(case):
    """``imu_window_cases.held``, the card's yardstick for K12: the twin
    passes against itself in f32 and f64; a row with one entry moved (a
    weight by 1e-3, a rotation by 1e-4 rad) or one NaN fails."""
    ops = (imu_window_cases.operands(3) if case == "synthetic"
           else imu_window_cases.edge(case, 3))
    f32 = [t.float() for t in ops]
    t32 = imu_ops.imu_window_plain(*f32, **_EPS)
    t64 = imu_ops.imu_window_plain(*[t.double() for t in f32], **_EPS)
    for dt, twin in ((torch.float32, t32), (torch.float64, t64)):
        res = imu_window_cases.held(twin, twin, t32, t64, dt)
        assert res["ok"] and res["worst_share"] == 0.0, res
        where = dict(imu_window_cases.entries(twin.shape[0] - 74))
        for name, d in (("w_int", 1e-3), ("int.delta_pose[3:]", 1e-4),
                        ("grav.rbar", math.nan)):
            bad = twin.clone()
            bad[where[name].start] += d
            res = imu_window_cases.held(bad, twin, t32, t64, dt)
            assert not res["ok"] and res["worst_entry"] == name, (name, res)


def test_imu_window_capture_hands_back_what_the_scan_gave_k12():
    """``imu_window_cases.captured`` (the card's captured operands) on a
    short CPU replay: the 11 operands of the last scan's K12 call, in f64,
    of the twin's shapes, the last scan's window among them."""
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    cfg = GCConfig.small()
    ops = imu_window_cases.captured(cfg, n_scans=3, device="cpu")
    M = cfg.imu_len
    assert [tuple(t.shape) for t in ops] == \
        list(belief_kernels._iw_shapes(M))
    assert all(t.dtype == torch.float64 for t in ops)
    ds = simulate(cfg, n_scans=3, seed=4, odom_drift_vel_scale=1.03,
                  odom_drift_yaw_rate=0.01)
    scans = to_scan_inputs(ds, cfg, device="cpu")
    assert torch.equal(ops[0], scans.imu_stamps[-1].double())
    assert torch.equal(ops[4], scans.scan_start[-1].double())
    assert bool(torch.isfinite(imu_ops.imu_window_plain(*ops, **_EPS)).all())


class _EmulatedLib:
    """K12's entry point emulated on the CPU through the raw pointers and
    instance strides it is given: per window, the operands read where the
    kernel reads them, the twin run on them, its row written where the
    kernel writes it."""

    def __init__(self):
        self.calls = []

    def imu_window_f64(self, *args):
        ptrs, (out, B, M, eps_mass, eps_psd) = args[:22], args[22:]
        self.calls.append(B)
        L = imu_ops.IMU_WINDOW_HEADER_LEN + M
        for b in range(B):
            ops = []
            for k, shape in enumerate(belief_kernels._iw_shapes(M)):
                n = math.prod(shape)
                buf = (ctypes.c_double * n).from_address(
                    ptrs[2 * k] + 8 * b * ptrs[2 * k + 1])
                ops.append(torch.frombuffer(buf, dtype=torch.float64)
                           .clone().reshape(shape))
            row = imu_ops.imu_window_plain(*ops, eps_mass, eps_psd)
            dst = (ctypes.c_double * L).from_address(out + 8 * b * L)
            torch.frombuffer(dst, dtype=torch.float64).copy_(row)
        return 0


def test_imu_window_launch_reads_each_window_through_its_stride(monkeypatch):
    """The wrapper's launch on operands laid out as the batching rule hands
    them: a window sliced out of a longer sequence (instance stride > row),
    gravity shared (stride 0), R_prev transposed (copied dense), leading
    axes (2, 2); each window's row is its twin's, and one window is one
    launch under its own counter."""
    lib = _EmulatedLib()
    monkeypatch.setattr(cuda_build, "library", lambda name: lib)
    monkeypatch.setattr(cuda_build, "launch",
                        lambda lib_, fn, what, dev, *a: fn(*a))
    sets = [_iw_operands(s) for s in range(10, 14)]
    ins = [torch.stack(ts) for ts in zip(*sets)]
    seq = torch.stack([ins[0], ins[0] + 1.0, ins[0] + 2.0], 1)  # (4, 3, M)
    ins[0] = seq[:, 0]
    ins[9] = sets[0][9].expand(4, 3)
    ins[10] = ins[10].transpose(-1, -2).contiguous().transpose(-1, -2)
    assert ins[0].stride(0) == 3 * 512 and ins[9].stride(0) == 0
    before = dict(belief_kernels.launches)
    rows = belief_kernels._imu_window_launch(ins, **_EPS)
    nested = belief_kernels._imu_window_launch(
        [t.reshape(2, 2, *t.shape[1:]) for t in ins], **_EPS)
    one = belief_kernels._imu_window_launch(sets[1], **_EPS)
    assert lib.calls == [4, 4, 1]
    assert belief_kernels.launches["imu_window_batched"] == \
        before["imu_window_batched"] + 2
    assert belief_kernels.launches["imu_window"] == \
        before["imu_window"] + 1
    for b in range(4):
        # dense fresh copies, as the emulation reads (the CPU's sums
        # depend on where a tensor starts and how it is laid out)
        want = imu_ops.imu_window_plain(
            *[t[b].clone(memory_format=torch.contiguous_format) for t in ins],
            **_EPS)
        assert torch.equal(rows[b], want)
        assert torch.equal(nested.reshape(4, -1)[b], want)
    assert torch.equal(one, imu_ops.imu_window_plain(
        *[t.clone(memory_format=torch.contiguous_format) for t in sets[1]],
        **_EPS))


# -- the plain versions against the JAX package at the kernels' edges ----

@pytest.mark.parametrize("case", ["one_cell", "all_out", "ragged"])
def test_moment_plain_matches_segment_sum_at_the_edges(case):
    """f64 against ``jax.ops.segment_sum`` (1e-12) on the cases the CUDA
    kernel is held to on the card: every id in one cell, every id out of
    range, N not a multiple of the span."""
    rng = np.random.default_rng(len(case))
    F, N, C = 64, 1025, 40
    payload = rng.normal(size=(F, N))
    cell = {"one_cell": np.full(N, 17),
            "all_out": np.where(rng.uniform(size=N) < 0.5, -1, C),
            "ragged": rng.integers(-3, C + 3, N)}[case]
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(payload.T),
                                          jnp.asarray(cell),
                                          num_segments=C)).T
    got = surfel_kernels.moment_segment_sum_plain(
        torch.from_numpy(payload), torch.from_numpy(cell), C).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("K,N", [(1, 96), (8, 5), (8, 137), (32, 64)])
def test_sinkhorn_plain_matches_jax_kernel_at_the_edges(K, N):
    """f64 against the JAX kernel in interpret mode (1e-9, the LSE sums in
    another order) at K = 1, K = 32, N below the cluster's 8 CTAs and N
    not a multiple of them."""
    rng = np.random.default_rng(K * 1000 + N)
    C = rng.uniform(0.0, 2.0, (N, K))
    C[rng.uniform(size=(N, K)) < 0.1] = 1e12
    a = rng.uniform(0.1, 1.0, N)
    a[0] = 0.0
    a /= a.sum()
    with np.errstate(divide="ignore"):
        log_a = np.where(a > 0, np.log(a), -np.inf)
    logKT = (-C / 0.1).T.copy()
    kw = dict(n_iter=20, ua=0.5 / 0.6, vb=0.5 / 0.6, log_b=-math.log(K))
    want = np.asarray(j_assoc.sinkhorn_piT(jnp.asarray(logKT),
                                           jnp.asarray(log_a), **kw,
                                           interpret=True))
    got = assoc_kernels.sinkhorn_piT(torch.from_numpy(logKT),
                                     torch.from_numpy(log_a), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert got[:, 0].max() == 0.0
