"""Noise injection (counterpart of ``mpc_cbf_tpu/ops/controls.py:42-48``).

Reference parity: ``math/src/Random.cpp`` (addRandomNoise). The JAX key
becomes an explicit ``torch.Generator``; the two draw different numbers
from the same seed. The nominal controllers of the JAX module are not
ported yet.
"""

from __future__ import annotations

import torch

from mpc_cbf_torch.types import State


def add_random_noise(generator: torch.Generator, state: State, pos_std: float,
                     vel_std: float) -> State:
    """Gaussian state noise (math::addRandomNoise, Random.cpp). The
    generator lives on the state's device; positions are drawn first."""
    def noise(x: torch.Tensor, std: float) -> torch.Tensor:
        return std * torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)

    return State(pos=state.pos + noise(state.pos, pos_std),
                 vel=state.vel + noise(state.vel, vel_std))
