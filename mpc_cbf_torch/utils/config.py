"""JSON config schema, compatible with the reference's experiment configs
(this package's own copy of ``mpc_cbf_tpu/utils/config.py``: json and numpy
only).

Reference parity: ``experiments/config/base_config.json`` (schema documented
in ``experiments/config/config.md``), merge semantics of
``experiments/python/preprocess.py:1-24`` (base config + per-task
``tasks{so,sf}``), validation invariants of ``common/parsing.hpp:36-103``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

from mpc_cbf_torch.controllers.bezier_mpc import BezierParams, MPCParams
from mpc_cbf_torch.controllers.mpc_cbf import IMPCParams


def load_config(base_path: str, task_path: Optional[str] = None) -> Dict[str, Any]:
    """Load base config, optionally merging a task file's ``tasks`` entry
    (preprocess.py merge semantics)."""
    with open(base_path) as f:
        cfg = json.load(f)
    if task_path is not None:
        with open(task_path) as f:
            task = json.load(f)
        cfg = {**cfg, "tasks": task.get("tasks", task)}
    return cfg


def parse_bezier_params(cfg: Dict[str, Any]) -> BezierParams:
    b = cfg["bezier_params"]
    return BezierParams(
        num_pieces=int(b["num_pieces"]),
        num_control_points=int(b["num_control_points"]),
        piece_max_parameter=float(b["piece_max_parameter"]),
        continuity_degree=int(b["bezier_continuity_upto_degree"]),
    )


def parse_mpc_params(cfg: Dict[str, Any]) -> MPCParams:
    m = cfg["mpc_params"]
    lim = cfg["physical_limits"]
    p = MPCParams(
        h=float(m["h"]),
        Ts=float(m["Ts"]),
        k_hor=int(m["k_hor"]),
        w_pos_err=float(m["mpc_tuning"]["w_pos_err"]),
        w_u_eff=float(m["mpc_tuning"]["w_u_eff"]),
        spd_f=int(m["mpc_tuning"]["spd_f"]),
        v_min=tuple(lim["v_min"]),
        v_max=tuple(lim["v_max"]),
        a_min=tuple(lim["a_min"]),
        a_max=tuple(lim["a_max"]),
    )
    p.validate(parse_bezier_params(cfg))
    return p


def parse_impc_params(cfg: Dict[str, Any]) -> IMPCParams:
    c = cfg["cbf_params"]
    return IMPCParams(
        cbf_horizon=int(c["cbf_horizon"]),
        impc_iter=int(c["impc_iter"]),
        slack_mode=bool(c.get("slack_mode", False)),
        slack_cost=float(c.get("slack_cost", 50000.0)),
        slack_decay_rate=float(c.get("slack_decay_rate", 0.1)),
    )


def parse_cbf_distances(cfg: Dict[str, Any]):
    c = cfg["cbf_params"]
    return float(c["d_min"]), float(c["d_max"])


def parse_collision_shape(cfg: Dict[str, Any]):
    """Returns (half_extents or radius, shape_type)
    (common/parsing.hpp parseCollisionShape / collision_check.py:90-100)."""
    shape = cfg["robot_params"]["collision_shape"]
    if "aligned_box" in shape:
        return np.asarray(shape["aligned_box"], dtype=float), "box"
    if "radius" in shape:
        return float(shape["radius"]), "circle"
    raise ValueError("collision_shape needs 'aligned_box' or 'radius'")


def parse_tasks(cfg: Dict[str, Any]):
    """(start_states [R, 3], goal_positions [R, 3]) from tasks{so,sf}."""
    so = np.asarray(cfg["tasks"]["so"], dtype=float)
    sf = np.asarray(cfg["tasks"]["sf"], dtype=float)
    if so.shape != sf.shape:
        raise ValueError("tasks so/sf shape mismatch")
    return so, sf


def parse_noise(cfg: Dict[str, Any]):
    lim = cfg["physical_limits"]
    return float(lim.get("pos_std", 0.0)), float(lim.get("vel_std", 0.0))
