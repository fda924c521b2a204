"""Offline scoring of rollouts, vectorized numpy (a copy of
``mpc_cbf_tpu/utils/metrics.py``, so a machine without JAX can score the
port's rollouts).

Reference parity: ``experiments/python/metrics/collision_check.py``
(instance_success :48-80), ``Metrics.py:68-92`` (avg neighbors in FOV),
``ComputeCI.py:4-44`` (95% CI / percentiles / inf-robust variants).
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


def instance_success_ref(
    traj: np.ndarray, goals: np.ndarray, radius: float = 1.0,
    collision_shape=(0.2, 0.2), shape_type: str = "box",
) -> Tuple[bool, float]:
    """(success, makespan) with the REFERENCE's scoring semantics.

    The reference's ``collision_check.py:48-80`` fails an instance on
    pairwise collision ONLY: its goal-reach check prints "Cannot reach goal
    area..." but the ``return False`` is commented out (:56-59), and the
    loop returns ``True, ts`` even if robots never reach their goals.
    ``instance_success`` is the STRICT scorer (collision + final position at
    goal); this one reproduces the reference, so grid tables compare with
    reference-scored runs. Report both.

    Caveat (kept as the JAX package has it): the collision scan runs over
    the whole trajectory, past the time at which all robots have reached
    their goals, where the reference stops at that time.

    Makespan: first step by which all robots have visited their goal area
    (the reference's ``max(0, t-1)`` early exit), else T.
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
    reached_by = (dist_to_goal <= radius).cumsum(axis=1) > 0
    all_reached = reached_by.all(axis=0)
    makespan = int(np.argmax(all_reached)) if all_reached.any() else traj.shape[1]
    return True, float(makespan)


def avg_neighbors_in_fov(traj: np.ndarray, fov: float, rng: float) -> float:
    """Mean number of neighbors inside each robot's FOV wedge over the run
    (Metrics.py:68-92). traj: [R, T, >=3] with [x, y, yaw].

    A robot is not its own neighbor. (The JAX package's "drop self" line
    writes into a copy, so its count is this one plus 1.)"""
    yaw = traj[..., 2]                                   # [R, T]
    rel = traj[None, :, :, :2] - traj[:, None, :, :2]    # [ego, other, T, 2]
    c, s = np.cos(yaw), np.sin(yaw)
    cx = c[:, None] * rel[..., 0] + s[:, None] * rel[..., 1]
    cy = -s[:, None] * rel[..., 0] + c[:, None] * rel[..., 1]
    dist = np.hypot(cx, cy)
    ang = np.abs(np.arctan2(cy, cx))
    inside = (ang <= 0.5 * fov) & (dist <= rng)
    ego = np.arange(inside.shape[0])
    inside[ego, ego] = False                             # drop self
    return float(inside.sum(axis=1).mean())


def ci95(samples: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """95% normal CI per row (ComputeCI.py:4-21). samples [entries, M]."""
    samples = np.asarray(samples, dtype=float)
    mean = samples.mean(axis=1)
    ci = 1.96 * samples.std(axis=1) / np.sqrt(samples.shape[1])
    return mean, ci


def ci95_with_inf(samples: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Inf-robust CI: drop non-finite samples per entry (ComputeCI.py:47+)."""
    samples = np.asarray(samples, dtype=float)
    mean, ci = [], []
    for row in samples:
        valid = row[np.isfinite(row)]
        if valid.size == 0:
            mean.append(np.inf)
            ci.append(0.0)
        else:
            mean.append(valid.mean())
            ci.append(1.96 * valid.std() / np.sqrt(valid.size))
    return np.asarray(mean), np.asarray(ci)


def percentiles(samples: np.ndarray):
    """(median, median-Q1, Q3-median) per row (ComputeCI.py:23-44)."""
    samples = np.asarray(samples, dtype=float)
    med = np.median(samples, axis=1)
    q1 = med - np.percentile(samples, 25, axis=1)
    q3 = np.percentile(samples, 75, axis=1) - med
    return med, q1, q3
