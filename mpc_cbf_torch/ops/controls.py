"""Nominal controllers and noise injection (counterpart of
``mpc_cbf_tpu/ops/controls.py``).

Reference parity: ``math/include/math/Controls.h`` +
``math/src/Controls.cpp`` (PID, criticallyDampedSpringControl) and
``math/src/Random.cpp`` (addRandomNoise). Stateless functional forms: the
PID integral term is threaded explicitly. The JAX key becomes an explicit
``torch.Generator``; the two draw different numbers from the same seed.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mpc_cbf_torch.types import State


def critically_damped_spring_control(state: State, target: torch.Tensor,
                                     spring_constant: float) -> torch.Tensor:
    """u = k (target - p) - 2 sqrt(k) v (Controls.h:17-27)."""
    return spring_constant * (target - state.pos) - 2.0 * math.sqrt(spring_constant) * state.vel


@dataclasses.dataclass(frozen=True)
class PIDParams:
    kp: float
    ki: float
    kd: float
    dt: float


def pid_control(params: PIDParams, state: State, integral_err: torch.Tensor,
                ref_pos: torch.Tensor, ref_vel: torch.Tensor, ref_acc: torch.Tensor):
    """One PID step; returns (u, new_integral_err) (Controls.cpp:13-23)."""
    pos_err = ref_pos - state.pos
    vel_err = ref_vel - state.vel
    integral_err = integral_err + pos_err * params.dt
    u = ref_acc + params.kp * pos_err + params.ki * integral_err + params.kd * vel_err
    return u, integral_err


def add_random_noise(generator: torch.Generator, state: State, pos_std: float,
                     vel_std: float) -> State:
    """Gaussian state noise (math::addRandomNoise, Random.cpp). The
    generator lives on the state's device; positions are drawn first."""
    def noise(x: torch.Tensor, std: float) -> torch.Tensor:
        return std * torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)

    return State(pos=state.pos + noise(state.pos, pos_std),
                 vel=state.vel + noise(state.vel, vel_std))
