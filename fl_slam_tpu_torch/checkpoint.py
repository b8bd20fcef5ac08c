"""Checkpoint / resume of the whole ``PipelineState`` (port of
``fl_slam_tpu/checkpoint.py``), in the reference's npz format: ``leaf_{i}``
for the state's tensors in the field order of ``PipelineState``, flattened
depth-first over its nested NamedTuples, plus ``__config__``, the producing
``GCConfig`` as sorted JSON. The two packages' states have the same fields
in the same order and their configs serialize alike, so a checkpoint
written by either loads in the other. Resume reproduces the replay's
continuation bit for bit.

``load_state`` checks the saved config against the resuming one field by
field, and every leaf's shape against the example state, and raises with
the mismatch.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def _config_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True)


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _rebuild(like, it):
    if isinstance(like, tuple):
        return type(like)(*[_rebuild(sub, it) for sub in like])
    return next(it)


def save_state(path, state, cfg=None) -> None:
    """Save a PipelineState (and the config that shaped it, when given)."""
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(_leaves(state))}
    if cfg is not None:
        arrays["__config__"] = np.frombuffer(
            _config_json(cfg).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path, like, cfg=None):
    """Load into the structure of ``like`` (an example PipelineState, e.g.
    from ``init_state`` with the same config): each leaf takes the dtype
    and device of ``like``'s leaf.

    When both the checkpoint and the caller carry a config, they must match
    exactly: every budget is a shape, and a silent mismatch would mis-slice
    the restored tensors."""
    data = np.load(path)
    if cfg is not None and "__config__" in data:
        saved = json.loads(bytes(data["__config__"]).decode())
        current = json.loads(_config_json(cfg))
        diff = {k: (saved.get(k), current.get(k))
                for k in set(saved) | set(current)
                if saved.get(k) != current.get(k)}
        if diff:
            raise ValueError(
                f"checkpoint config mismatch (saved vs current): {diff}")
    leaves = []
    for i, ref in enumerate(_leaves(like)):
        arr = data[f"leaf_{i}"]
        if arr.shape != tuple(ref.shape):
            raise ValueError(
                f"checkpoint leaf {i} shape {arr.shape} != expected "
                f"{tuple(ref.shape)} (config mismatch?)")
        leaves.append(torch.from_numpy(arr).to(device=ref.device,
                                               dtype=ref.dtype))
    return _rebuild(like, iter(leaves))
