"""The slab exchange's edge cases and byte counts
(``structures/exchange_cases.py``), which the CUDA tests and
``chip_smoke.py`` hold K5 / K7 / K10 at, the pose digests that hold
two trees of the port to the same trajectories
(``pose_digest.py``), and the refusal of both scripts to run without a
card."""

import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from fl_slam_tpu_torch import pose_digest
from fl_slam_tpu_torch.structures import atlas_kernels, exchange_cases

P, S = 64, 7


@pytest.mark.parametrize("edge", exchange_cases.EDGES)
def test_edge_slots_are_distinct_pool_slots(edge):
    rng = np.random.default_rng(0)
    old, new = exchange_cases.edge_slots(edge, P, S, rng)
    assert old.dtype == new.dtype == np.int32
    for slots in (old, new):
        assert len(set(slots.tolist())) == S
        assert slots.min() >= 0 and slots.max() < P


# (tiles that stay resident, of them at their own index) by edge at S = 7.
STAYS = {"identity": (7, 7), "permutation": (7, 0), "disjoint": (0, 0),
         "overlap": (3, 1), "odd_m": (3, 1), "f64": (3, 1)}


@pytest.mark.parametrize("edge", exchange_cases.EDGES)
def test_edges_keep_the_tiles_they_name(edge):
    old, new = exchange_cases.edge_slots(edge, P, S,
                                         np.random.default_rng(1))
    stay = sum(int(n in old) for n in new)
    same = int((old == new).sum())
    assert (stay, same) == STAYS[edge]
    assert exchange_cases.exchange_strips(old, new) == (2 * S - stay,
                                                        2 * S - same)


def test_edge_m_and_dtype():
    assert exchange_cases.edge_m("odd_m", 1000) == 1001
    assert exchange_cases.edge_m("odd_m", 50176) == 50177
    assert exchange_cases.edge_m("odd_m", 7) == 7
    assert exchange_cases.edge_m("overlap", 1000) == 1000
    assert exchange_cases.edge_dtype("f64") == "float64"
    assert exchange_cases.edge_dtype("odd_m") == "float32"


def test_exchange_bytes_counts_flagged_instances_only():
    """The timed case of chip_smoke.py: 4 of 7 tiles stay, one at its own
    index: 10 strips read and 13 written of (32 x 4 + 4) x 50176 bytes."""
    old = [[3, 9, 17, 20, 33, 41, 60]]
    new = [[9, 5, 17, 62, 41, 0, 3]]
    row = 50176 * (32 * 4 + 4)
    assert exchange_cases.exchange_strips(old[0], new[0]) == (10, 13)
    assert exchange_cases.exchange_bytes(old, new, [1], 32, 50176, 4) == \
        4 + 2 * 7 * 4 + 23 * row
    assert exchange_cases.exchange_bytes(old, new, [0], 32, 50176, 4) == 4
    two = exchange_cases.exchange_bytes(old * 2, new * 2, [1, 0], 32,
                                        50176, 8)
    assert two == 8 + 2 * 7 * 4 + 23 * 50176 * (32 * 8 + 4)


@pytest.mark.parametrize("edge", exchange_cases.EDGES)
def test_plain_twin_moves_only_the_strips_counted(edge):
    """What the plain twin changes at an edge: the flushed pool slots, and
    the slab blocks that do not stay at their own index."""
    rng = np.random.default_rng(2)
    M, CF = exchange_cases.edge_m(edge, 16), 3
    dt = getattr(torch, exchange_cases.edge_dtype(edge))
    old, new = exchange_cases.edge_slots(edge, P, S, rng)
    pool_f = torch.randn((P, CF, M), dtype=dt)
    pool_p = torch.randint(0, 100, (P, M), dtype=torch.int32)
    ff = torch.randn((CF, S * M), dtype=dt)
    fp = torch.randint(100, 200, (S * M,), dtype=torch.int32)
    got = atlas_kernels.conditional_slab_exchange_ff_plain(
        *[t.clone() for t in (pool_f, pool_p, ff, fp)],
        torch.from_numpy(old), torch.from_numpy(new), torch.tensor(1))
    slabs = got[2].view(CF, S, M)
    moved = [s for s in range(S)
             if not torch.equal(slabs[:, s], ff.view(CF, S, M)[:, s])]
    written = [s for s in range(S) if old[s] != new[s]]
    assert moved == written          # random data: a move changes a block
    pools = [p for p in range(P) if not torch.equal(got[0][p], pool_f[p])]
    assert pools == sorted(old.tolist())


def test_pose_digest_is_the_sha256_of_the_bytes():
    a = np.arange(12, dtype=np.float32).reshape(2, 6)
    d = pose_digest.digest(a)
    assert d == {"shape": [2, 6], "dtype": "float32",
                 "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    assert pose_digest.digest(a.T)["sha256"] == hashlib.sha256(
        np.ascontiguousarray(a.T).tobytes()).hexdigest()
    b = a.copy()
    b[1, 5] = np.nextafter(b[1, 5], np.float32(1e9))
    assert pose_digest.digest(b)["sha256"] != d["sha256"]


def test_pose_digest_wants_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert pose_digest.main([]) == 2


def test_chip_smoke_wants_a_card(monkeypatch, capsys):
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
