"""Collision shapes and aligned-box geometry helpers (counterpart of
``mpc_cbf_tpu/ops/collision_shapes.py``).

Reference parity:
- ``math/include/math/collision_shapes/CollisionShape.h:10-77``
  (abstract Type / convexHullPoints / boundingBox / inflate)
- ``math/include/math/collision_shapes/AlignedBoxCollisionShape.h:8-45``
- ``math/src/Helpers.cpp``: cornerPoints, snapHyperplane (:141-148),
  boundingHyperplanes (:150-163), bufferAlignedBox (:39-43),
  linearInterpolate (:165-170)

Shapes are static (config-time) objects; their geometry queries are
branch-free tensor code over the last axis, so positions may carry leading
batch axes. An aligned box is the pair ``(box_min, box_max)`` of (DIM,)
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def corner_points(box_min: Tensor, box_max: Tensor) -> Tensor:
    """All 2^DIM corners of an aligned box: [..., 2^DIM, DIM]
    (math::cornerPoints, Helpers.cpp)."""
    dim = box_min.shape[-1]
    # static corner-selection mask: bit d of corner c picks min/max along d
    sel = torch.tensor([[(c >> d) & 1 for d in range(dim)] for c in range(2 ** dim)],
                       dtype=torch.bool, device=box_min.device)
    return torch.where(sel, box_max[..., None, :], box_min[..., None, :])


def snap_hyperplane(normal: Tensor, offset: Tensor, points: Tensor) -> Tensor:
    """Shift a hyperplane until it touches the closest of ``points``
    (Helpers.cpp:141-148): offset' = offset - min_i signedDistance(p_i),
    signedDistance(p) = normal . p + offset. Returns the new offset.

    points: [..., P, DIM]; normal: [..., DIM]; offset: [...].
    """
    sd = torch.sum(points * normal[..., None, :], dim=-1) + offset[..., None]
    return offset - torch.amin(sd, dim=-1)


def bounding_hyperplanes(box_min: Tensor, box_max: Tensor) -> Tuple[Tensor, Tensor]:
    """The 2*DIM hyperplanes bounding an aligned box, as
    (normals [2*DIM, DIM], offsets [..., 2*DIM]) with normal . x + offset <= 0
    inside (Helpers.cpp:150-163): (+e_d, -max_d) and (-e_d, +min_d)."""
    eye = torch.eye(box_min.shape[-1], dtype=box_min.dtype, device=box_min.device)
    return torch.cat([eye, -eye], dim=0), torch.cat([-box_max, box_min], dim=-1)


def buffer_aligned_box(box_min: Tensor, box_max: Tensor,
                       zero_min, zero_max) -> Tuple[Tensor, Tensor]:
    """Erode ``box`` by a shape-at-zero so that positions inside the result
    keep the translated shape inside the original box
    (bufferAlignedBox, Helpers.cpp:39-43)."""
    as_box = lambda a: torch.as_tensor(a, dtype=box_min.dtype, device=box_min.device)
    return box_min - as_box(zero_min), box_max - as_box(zero_max)


def linear_interpolate(t1: Tensor, p1: Tensor, t2: Tensor, p2: Tensor, t: Tensor) -> Tensor:
    """Point on the line through (t1, p1), (t2, p2) at parameter t
    (Helpers.cpp:165-170)."""
    ratio = (t - t1) / (t2 - t1)
    return p1 + ratio[..., None] * (p2 - p1)


@dataclasses.dataclass(frozen=True)
class AlignedBoxCollisionShape:
    """Axis-aligned-box collision shape at zero, translated by position
    (AlignedBoxCollisionShape.h:8-45). ``zero_min``/``zero_max`` are numpy
    (DIM,) vectors fixed at build time."""

    zero_min: np.ndarray
    zero_max: np.ndarray

    TYPE = "ALIGNED_BOX"  # CollisionShape::Type::ALIGNED_BOX

    @classmethod
    def from_half_extents(cls, half_extents) -> "AlignedBoxCollisionShape":
        h = np.asarray(half_extents, dtype=float)
        return cls(zero_min=-h, zero_max=h)

    @property
    def half_extents(self) -> np.ndarray:
        return (self.zero_max - self.zero_min) / 2.0

    def convex_hull_points(self, position: Tensor) -> Tensor:
        """[..., 2^DIM, DIM] corners of the shape translated to ``position``
        (Minkowski sum semantics of the reference)."""
        return corner_points(*self.bounding_box(position))

    def bounding_box(self, position: Tensor) -> Tuple[Tensor, Tensor]:
        """(min, max) of the shape at ``position``."""
        as_pos = lambda a: torch.as_tensor(a, dtype=position.dtype, device=position.device)
        return position + as_pos(self.zero_min), position + as_pos(self.zero_max)

    def inflate(self, amount: float) -> "AlignedBoxCollisionShape":
        """Grow by ``amount`` in every primary direction
        (AlignedBoxCollisionShape.h:27-34)."""
        return AlignedBoxCollisionShape(zero_min=self.zero_min - amount,
                                        zero_max=self.zero_max + amount)
