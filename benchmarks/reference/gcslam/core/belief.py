"""22D information-form belief over chart GC-RIGHT-01 (port of
``fl_slam_tpu/core/belief.py``). A plain NamedTuple of tensors; the
hypothesis bank is an explicit leading K axis."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import D_Z, IDX_POSE
from ..core import se3
from ..core.linalg import spd_solve_lifted


class Belief(NamedTuple):
    L: torch.Tensor        # (..., 22, 22) information matrix
    h: torch.Tensor        # (..., 22) information vector
    anchor: torch.Tensor   # (..., 7) [t, quat wxyz] world anchor


def identity_belief(dtype, device, prior_info: float = 1e-6,
                    anchor=None) -> Belief:
    """Weak identity prior; ``anchor`` is a 3-, 6- or 7-vector."""
    L = torch.eye(D_Z, dtype=dtype, device=device) * prior_info
    h = torch.zeros((D_Z,), dtype=dtype, device=device)
    if anchor is None:
        anchor = torch.zeros((3,), dtype=dtype, device=device)
    anchor = torch.as_tensor(anchor, dtype=dtype, device=device)
    if anchor.shape[-1] == 3:
        anchor = torch.cat([anchor, torch.zeros_like(anchor)])
    if anchor.shape[-1] == 6:
        anchor = se3.pose7_from_pose6(anchor)
    return Belief(L=L, h=h, anchor=anchor)


def mean_increment(b: Belief, eps_lift: float = 1e-9):
    return spd_solve_lifted(b.L, b.h, eps_lift)[0]


def world_pose7(b: Belief, eps_lift: float = 1e-9):
    """X_anchor o Exp(delta_xi_pose) as a 7-vector [t, quat]
    (parity: ``fl_slam_tpu/core/belief.py:67``)."""
    return world_pose7_from_increment(b, mean_increment(b, eps_lift))


def world_pose(b: Belief, eps_lift: float = 1e-9):
    return se3.pose6_from_pose7(world_pose7(b, eps_lift))


def world_pose7_from_increment(b: Belief, dz):
    """(parity: ``fl_slam_tpu/core/belief.py:81``)."""
    return se3.pose7_plus(b.anchor, dz[..., IDX_POSE])


def world_pose_from_increment(b: Belief, dz):
    return se3.pose6_from_pose7(world_pose7_from_increment(b, dz))


def shift_chart(b: Belief, shift) -> Belief:
    """Move the linearization point by ``shift`` (22-D) without changing
    the distribution to first order: h' = h - L shift
    (parity: ``fl_slam_tpu/core/belief.py:89``)."""
    return b._replace(h=b.h - torch.einsum("...ij,...j->...i", b.L, shift))


class HypothesisSet(NamedTuple):
    """The K-hypothesis bank: beliefs stacked on a leading axis, and their
    weights (K,) (parity: ``fl_slam_tpu/core/belief.py:101``). The pipeline
    carries the same two as ``PipelineState.belief`` / ``hyp_weights``."""

    belief: Belief
    weights: torch.Tensor


def floor_and_normalize_weights(w, floor: float):
    w = torch.clamp(w, min=floor)
    return w / torch.sum(w, dim=-1, keepdim=True)
