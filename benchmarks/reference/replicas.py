"""The reference of the instance-batched replay: each instance's sequence
replayed alone, from its own initial state, through ``replay_segments``.

This is the deployment's guarantee: instances share nothing, so instance
b's poses and certificates are what its sequence alone gives, whatever the
other instances hold."""

from __future__ import annotations

from . import replay


def replay_instance(cfg, fields: dict, seg_len: int, t0: float, n: int,
                    device, precision: str = "f32"):
    """The first ``n`` scans of one instance's sequence, alone, in segments
    of ``seg_len``. Returns (poses (n, 6) f64, {cert: (n,) f64})."""
    return replay.replay_segments(cfg, fields, seg_len, t0, n, device,
                                  precision=precision)


def replay_instances(cfg, sequences: list, seg_len: int, t0s: list, n: int,
                     device, precision: str = "f32") -> list:
    """``replay_instance`` of each instance's fields, in instance order."""
    return [replay_instance(cfg, f, seg_len, t0, n, device, precision)
            for f, t0 in zip(sequences, t0s)]
