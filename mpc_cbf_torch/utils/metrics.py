"""Offline scoring of rollouts, vectorized numpy (a copy of
``mpc_cbf_tpu/utils/metrics.py``'s collision checks and
``instance_success``, so a machine without JAX can score the port's
rollouts).

Reference parity: ``experiments/python/metrics/collision_check.py``
(instance_success :48-80). Not ported yet: ``instance_success_ref``, the
FOV-neighbor metric and the confidence-interval helpers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pairwise_box_collisions(traj_xy: np.ndarray, half_extents) -> np.ndarray:
    """Axis-aligned box overlap per timestep.

    traj_xy: [R, T, 2]; half_extents: (hx, hy) — the reference inflates each
    box to 2x its collision_shape and checks rectangle overlap
    (collision_check.py:11-39), which reduces to |dx| < 2*hx and |dy| < 2*hy.
    Returns bool [T] — any colliding pair at each t.
    """
    hx, hy = half_extents
    d = np.abs(traj_xy[:, None] - traj_xy[None, :])  # [R, R, T, 2]
    hit = (d[..., 0] < 2 * hx) & (d[..., 1] < 2 * hy)
    R = traj_xy.shape[0]
    iu = np.triu_indices(R, k=1)
    return hit[iu].any(axis=0)


def pairwise_circle_collisions(traj_xy: np.ndarray, radius: float) -> np.ndarray:
    """Disc overlap per timestep (collision_check.py:24-28): dist <= 2r."""
    d = np.linalg.norm(traj_xy[:, None] - traj_xy[None, :], axis=-1)
    R = traj_xy.shape[0]
    iu = np.triu_indices(R, k=1)
    return (d[iu] <= 2 * radius).any(axis=0)


def instance_success(
    traj: np.ndarray, goals: np.ndarray, radius: float = 1.0,
    collision_shape=(0.2, 0.2), shape_type: str = "box",
) -> Tuple[bool, float]:
    """(success, makespan) for one run (collision_check.py:48-80).

    traj: [R, T, >=2] states; goals: [R, >=2]. Success = no pairwise
    collision at any step and every robot's final position within `radius`
    of its goal; makespan = first step by which all robots have visited
    their goal area.
    """
    traj = np.asarray(traj)
    goals = np.asarray(goals)
    if not np.all(np.isfinite(traj)):
        return False, float("inf")
    xy = traj[..., :2]
    if shape_type == "box":
        col = pairwise_box_collisions(xy, collision_shape)
    elif shape_type == "circle":
        col = pairwise_circle_collisions(xy, collision_shape)
    else:
        raise ValueError(f"unknown shape_type {shape_type}")
    if col.any():
        return False, float("inf")

    dist_to_goal = np.linalg.norm(xy - goals[:, None, :2], axis=-1)  # [R, T]
    if (dist_to_goal[:, -1] > radius).any():
        return False, float("inf")
    reached_by = (dist_to_goal <= radius).cumsum(axis=1) > 0  # [R, T]
    all_reached = reached_by.all(axis=0)
    makespan = int(np.argmax(all_reached)) if all_reached.any() else traj.shape[1]
    return True, float(makespan)
