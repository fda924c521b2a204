"""Task-instance generators, numpy (a copy of
``mpc_cbf_tpu/utils/instances.py``, so a machine without JAX can make the
same instances).

Reference parity: ``experiments/python/instances/generate_circle_instances.py``
and ``generate_formation_instances.py`` — robots on a circle swapping to the
antipodal point, and formation layouts. Output follows the tasks{so,sf}
schema of the JAX package's config files.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def circle_swap_instance(num_robots: int, radius: float = 3.0,
                         yaw_facing_center: bool = True) -> Dict:
    """Robots evenly spaced on a circle, goals at the antipodal points."""
    ang = 2 * np.pi * np.arange(num_robots) / num_robots
    so = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                   (ang + np.pi) % (2 * np.pi) if yaw_facing_center else np.zeros_like(ang)],
                  axis=-1)
    goal_ang = ang + np.pi
    sf = np.stack([radius * np.cos(goal_ang), radius * np.sin(goal_ang),
                   so[:, 2]], axis=-1)
    return {"tasks": {"so": so.tolist(), "sf": sf.tolist()}}


def line_to_line_instance(num_robots: int, spacing: float = 1.5,
                          travel: float = 4.0) -> Dict:
    """A rank of robots translating forward together (formation keep)."""
    y = spacing * (np.arange(num_robots) - (num_robots - 1) / 2)
    so = np.stack([np.zeros(num_robots), y, np.zeros(num_robots)], axis=-1)
    sf = so + np.array([travel, 0.0, 0.0])
    return {"tasks": {"so": so.tolist(), "sf": sf.tolist()}}


def random_instance(num_robots: int, box: float = 5.0, min_sep: float = 1.5,
                    seed: int = 0, max_tries: int = 10000) -> Dict:
    """Random collision-free starts and goals inside a [-box, box]^2 arena."""
    rng = np.random.default_rng(seed)

    def sample_set():
        pts = []
        tries = 0
        while len(pts) < num_robots:
            p = rng.uniform(-box, box, size=2)
            if all(np.linalg.norm(p - q) >= min_sep for q in pts):
                pts.append(p)
            tries += 1
            if tries > max_tries:
                raise RuntimeError("cannot place robots with given min_sep")
        return np.asarray(pts)

    so_xy, sf_xy = sample_set(), sample_set()
    yaw = rng.uniform(-np.pi, np.pi, size=(num_robots, 1))
    so = np.concatenate([so_xy, yaw], axis=-1)
    sf = np.concatenate([sf_xy, yaw], axis=-1)
    return {"tasks": {"so": so.tolist(), "sf": sf.tolist()}}


def circle_rotate_instance(num_robots: int, radius: float = 3.0) -> Dict:
    """Cyclic rotation on a circle: each robot's goal is its successor's
    start. Feasible for every controller family (the antipodal swap of
    circle_swap_instance deadlocks single-step CBF-QPs head-on)."""
    inst = circle_swap_instance(num_robots, radius)
    so = np.asarray(inst["tasks"]["so"])
    sf = np.roll(so, -1, axis=0)
    return {"tasks": {"so": so.tolist(), "sf": sf.tolist()}}


def formation_instance(num_robots: int, n_row: int = 2, dx: float = 1.5,
                       dy: float = 1.5, travel: float = 4.0) -> Dict:
    """Grid formation translating forward (reference
    generate_formation_instance1.py / generate_points_on_formation)."""
    cols = int(np.ceil(num_robots / n_row))
    idx = np.arange(num_robots)
    x = (idx % cols) * dx
    y = (idx // cols) * dy
    so = np.stack([x, y, np.zeros(num_robots)], axis=-1)
    sf = so + np.array([travel, 0.0, 0.0])
    return {"tasks": {"so": so.tolist(), "sf": sf.tolist()}}


def fov_circle_instance(num_robots: int, radius: float = 3.0) -> Dict:
    """Antipodal circle swap with yaw facing the circle center — the FoV
    instance layout (generate_fov_instance.py: compute_yaw toward center)."""
    ang = 2 * np.pi * np.arange(num_robots) / num_robots
    x, y = radius * np.cos(ang), radius * np.sin(ang)
    yaw = np.arctan2(-y, -x)
    so = np.stack([x, y, yaw], axis=-1)
    gx, gy = -x, -y
    gyaw = np.arctan2(-gy, -gx)
    sf = np.stack([gx, gy, gyaw], axis=-1)
    return {"tasks": {"so": np.round(so, 3).tolist(),
                      "sf": np.round(sf, 3).tolist()}}
