"""Carry state across the two packages as numpy arrays.

``state_from_numpy`` builds the port's ``PipelineState`` from any object
with the same field names and nesting whose leaves are numpy arrays (for
example the JAX package's ``PipelineState`` after ``np.asarray`` on every
leaf); ``state_to_numpy`` turns the port's state back into the same
structure with numpy leaves. ``scans_from_numpy`` does the same for a
stacked ``ScanInput`` (or a dict of its fields). A SLAM has no weights: its
state (belief, IW noise, tile pool, resident slabs) takes their place.
"""

from __future__ import annotations

import numpy as np
import torch

from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.core.belief import Belief
from fl_slam_tpu_torch.ops.noise import MeasurementNoiseIW, ProcessNoiseIW
from fl_slam_tpu_torch.pipeline import PipelineState, ScanInput
from fl_slam_tpu_torch.runtime import resolve_device
from fl_slam_tpu_torch.structures.atlas import AtlasMap, SlabsFF

_NESTED = {"belief": Belief, "process_noise": ProcessNoiseIW,
           "meas_noise": MeasurementNoiseIW, "atlas": AtlasMap,
           "slabs": SlabsFF}


def _leaf(x, cfg: GCConfig, dev):
    a = np.asarray(x)
    if a.dtype.kind == "f":
        return torch.tensor(a, dtype=cfg.torch_dtype, device=dev)
    return torch.tensor(a, device=dev)


def _build(cls, src, cfg, dev):
    fields = {}
    for name in cls._fields:
        val = getattr(src, name)
        sub = _NESTED.get(name) if cls is PipelineState else None
        fields[name] = (_build(sub, val, cfg, dev) if sub is not None
                        else _leaf(val, cfg, dev))
    return cls(**fields)


def state_from_numpy(src, cfg: GCConfig, device=None) -> PipelineState:
    return _build(PipelineState, src, cfg, resolve_device(device))


def scans_from_numpy(src, cfg: GCConfig, device=None) -> ScanInput:
    dev = resolve_device(device)
    get = src.get if isinstance(src, dict) else (lambda k: getattr(src, k))
    return ScanInput(**{k: _leaf(get(k), cfg, dev) for k in ScanInput._fields})


def state_to_numpy(state):
    """Same NamedTuple structure with numpy leaves."""
    if hasattr(state, "_fields"):
        return type(state)(*[state_to_numpy(v) for v in state])
    return state.detach().cpu().numpy()
