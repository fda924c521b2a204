"""Geometry primitives on the ported slices: separating hyperplanes,
confidence-ellipse distances and yaw wrapping (counterpart of
``mpc_cbf_tpu/ops/geometry.py`` lines 29-120 and 139-150).

Reference parity:
- Voronoi hyperplane: ``separating_hyperplanes/src/Voronoi.cpp:10-29``
- shiftHyperplane / collision-shape support:
  ``math/src/Helpers.cpp`` + ``math/collision_shapes/AlignedBoxCollisionShape.h``
- distance to 90% confidence ellipse:
  ``mpc_cbf/src/controller/FovBezierIMPCCBF.cpp:226-291`` /
  ``math/src/Geometry.cpp:8-57`` (closestPointOnEllipse)

- yaw wrapping: ``math/src/Geometry.cpp:76-86``, ``Geometry.h:77-104``

Branch-free (``torch.where``), operating on the last axis and broadcasting
over leading axes. FOV tests and control rotations are not ported yet.
"""

from __future__ import annotations

import math

import torch


def voronoi_hyperplane(p_self: torch.Tensor, p_other: torch.Tensor, eps: float = 1e-12):
    """Perpendicular-bisector hyperplane (normal, offset) with
    normal . x + offset <= 0 on the side of p_self.

    Matches Voronoi.cpp:10-29: normal is the unit vector from self to other,
    offset = -normal . midpoint.
    """
    d = p_other - p_self
    norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    normal = d / torch.clamp_min(norm, eps)
    mid = 0.5 * (p_self + p_other)
    offset = -torch.sum(normal * mid, dim=-1)
    return normal, offset


def shift_hyperplane_for_box(normal: torch.Tensor, offset: torch.Tensor,
                             box_half_extents: torch.Tensor) -> torch.Tensor:
    """Shift offset so a box (half-extents, centered at its position) on the
    negative side keeps the whole box on the negative side of the original.

    The support of an axis-aligned box in direction n is sum(|n| * half_ext),
    equivalent to the reference's corner-point max (math::shiftHyperplane).
    Returns the new offset (normal unchanged).
    """
    support = torch.sum(torch.abs(normal) * box_half_extents, dim=-1)
    return offset + support


def eigh_2x2(cov: torch.Tensor):
    """Closed-form eigendecomposition of a symmetric 2x2 matrix.

    Returns (eigvals [.., 2] ascending, eigvecs [.., 2, 2] with columns as
    eigenvectors). Replaces Eigen::EigenSolver on covariance blocks.
    """
    a = cov[..., 0, 0]
    b = cov[..., 0, 1]
    c = cov[..., 1, 1]
    tr = a + c
    disc = torch.sqrt(torch.clamp_min(0.25 * (a - c) ** 2 + b * b, 0.0))
    lam1 = 0.5 * tr - disc  # smaller
    lam2 = 0.5 * tr + disc  # larger
    # Eigenvector for lam2: (b, lam2 - a) unless degenerate.
    nondegenerate = torch.abs(b) > 1e-18
    a_major = a >= c
    v2x = torch.where(nondegenerate, b, a_major.to(cov.dtype))
    v2y = torch.where(nondegenerate, lam2 - a, (~a_major).to(cov.dtype))
    n2 = torch.sqrt(v2x * v2x + v2y * v2y)
    v2x, v2y = v2x / n2, v2y / n2
    # v1 orthogonal to v2
    v1x, v1y = -v2y, v2x
    vals = torch.stack([lam1, lam2], dim=-1)
    vecs = torch.stack(
        [torch.stack([v1x, v2x], dim=-1), torch.stack([v1y, v2y], dim=-1)], dim=-2
    )
    return vals, vecs


# 90% confidence interval scale for a 2-dof chi-square
# (FovBezierIMPCCBF.cpp:237-240).
CONF_90 = 4.605


def distance_to_ellipse(robot_xy: torch.Tensor, mean_xy: torch.Tensor,
                        cov2: torch.Tensor, s: float = CONF_90) -> torch.Tensor:
    """Signed distance from robot to the s-scaled covariance ellipse.

    Negative when the robot is inside the ellipse; mirrors
    FovBezierIMPCCBF::distanceToEllipse (FovBezierIMPCCBF.cpp:226-291)
    including its approximation of the closest boundary point and the
    nan -> 5.0 and infinite-cov -> -5.0 fallbacks.
    """
    vals, vecs = eigh_2x2(cov2)
    # a (major) = sqrt(s*lam2), b = sqrt(s*lam1), lam2 >= lam1
    a = torch.sqrt(torch.clamp_min(s * vals[..., 1], 0.0))
    b = torch.sqrt(torch.clamp_min(s * vals[..., 0], 0.0))
    theta = torch.atan2(vecs[..., 1, 1], vecs[..., 0, 1])
    theta = torch.where(theta < 0.0, theta + math.pi, theta)

    slope = torch.atan2(
        robot_xy[..., 1] - mean_xy[..., 1], robot_xy[..., 0] - mean_xy[..., 0]
    )
    ct, st = torch.cos(theta), torch.sin(theta)
    cs, ss = torch.cos(slope - theta), torch.sin(slope - theta)
    x_n = mean_xy[..., 0] + a * cs * ct - b * ss * st
    y_n = mean_xy[..., 1] + a * cs * st + b * ss * ct

    dist = torch.sqrt((x_n - robot_xy[..., 0]) ** 2 + (y_n - robot_xy[..., 1]) ** 2)
    dist = torch.where(torch.isnan(dist), torch.full_like(dist, 5.0), dist)

    d_center = torch.linalg.vector_norm(mean_xy - robot_xy, dim=-1)
    rng = torch.sqrt((mean_xy[..., 0] - x_n) ** 2 + (mean_xy[..., 1] - y_n) ** 2)
    signed = torch.where(d_center < rng, -dist, dist)
    # infinite covariance -> sensor lost the target: reference returns -5
    return torch.where(torch.isinf(cov2[..., 0, 0]), torch.full_like(signed, -5.0), signed)


def convert_yaw_in_range(yaw: torch.Tensor) -> torch.Tensor:
    """Wrap yaw into (-pi, pi] (Geometry.cpp:76-86)."""
    return torch.where(yaw > math.pi, yaw - 2 * math.pi,
                       torch.where(yaw < -math.pi, yaw + 2 * math.pi, yaw))


def convert_to_closest_yaw(current_yaw: torch.Tensor, goal_yaw: torch.Tensor) -> torch.Tensor:
    """Pick goal_yaw + {0, ±2π} closest to current_yaw (Geometry.h:77-104).
    On a tie the first candidate wins (``torch.argmin`` keeps the first
    minimum, as ``jnp.argmin`` does)."""
    cands = torch.stack([goal_yaw, goal_yaw + 2 * math.pi, goal_yaw - 2 * math.pi], dim=-1)
    idx = torch.argmin(torch.abs(cands - current_yaw[..., None]), dim=-1)
    return torch.take_along_dim(cands, idx[..., None], dim=-1)[..., 0]
