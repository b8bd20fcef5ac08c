"""The edges the slab exchange (K5 / K7 / K10) is held at, and the bytes an
exchange must move: its slot sets by edge, each edge's M and dtype, and
the strips a flagged instance reads and writes. ``chip_smoke.py`` and the
tests share them.
"""

from __future__ import annotations

import numpy as np

# identity: new == old (the first chunk's exchange); permutation: every
# tile stays, none at its own index; disjoint: no tile stays; overlap: some
# tiles stay, one at its own index; odd_m: overlap at an odd M (the
# kernel's per-element path); f64: overlap in float64.
EDGES = ("identity", "permutation", "disjoint", "overlap", "odd_m", "f64")


def edge_slots(edge: str, P: int, S: int, rng) -> tuple:
    """(old, new) int32 slot sets of one instance at ``edge``, from the
    numpy generator ``rng``; each set distinct, as ``activate_tiles`` gives
    them. Needs P >= 2S."""
    perm = rng.permutation(P)
    old = perm[:S].copy()
    if edge == "identity":
        new = old.copy()
    elif edge == "permutation":
        new = np.roll(old, 1)
    else:
        new = perm[S:2 * S].copy()
        if edge != "disjoint":
            new[0] = old[min(1, S - 1)]
            if S >= 3:
                new[2] = old[2]
            if S >= 4:
                new[S - 1] = old[0]
    return old.astype(np.int32), new.astype(np.int32)


def edge_m(edge: str, M: int) -> int:
    """The M an edge runs at: odd for ``odd_m``."""
    return M + 1 - M % 2 if edge == "odd_m" else M


def edge_dtype(edge: str) -> str:
    return "float64" if edge == "f64" else "float32"


def exchange_strips(old, new) -> tuple:
    """(strips read, strips written) per row of one flagged instance: its
    S resident strips and the pool strips of the tiles that do not stay;
    the S flushed strips and the gathered ones that do not stay at their
    own index."""
    old, new = list(np.asarray(old)), list(np.asarray(new))
    S = len(old)
    stay = sum(int(n in old) for n in new)
    same = sum(int(o == n) for o, n in zip(old, new))
    return S + S - stay, S + S - same


def exchange_bytes(olds, news, flags, CF: int, M: int,
                   itemsize: int) -> int:
    """The bytes an exchange of B instances must move: each flag read, and
    for each flagged instance its slots and the strips of
    ``exchange_strips``, CF field rows of ``itemsize`` bytes and the int32
    prim-id row."""
    total = 0
    for old, new, flag in zip(np.asarray(olds), np.asarray(news),
                              np.asarray(flags).reshape(-1)):
        total += 4
        if flag:
            rd, wr = exchange_strips(old, new)
            total += 2 * len(old) * 4 + (rd + wr) * M * (CF * itemsize + 4)
    return total
