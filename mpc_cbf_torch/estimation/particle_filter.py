"""SIR particle filter for neighbor-state estimation, batched over a bank
of filters (counterpart of ``mpc_cbf_tpu/estimation/particle_filter.py``).

Reference parity: ``particle_filter/src/detail/particle_filter.cpp``
(init :12-56, predict :63-83, update :85-104, resample :106-118,
estimateState/getDistribution) and ``pf_applications.cpp:8-45``
(processFovUpdate: predict -> FOV negative-information down-weighting ->
conditional measurement update -> resample -> mean/cov).

As in the JAX package:
- multinomial std::discrete_distribution resampling becomes *systematic*
  resampling (sort-free: one cumsum + one searchsorted), the standard
  variance-reduced choice,
- the FOV visibility branch becomes a weight blend (branch-free).

A bank is a ``PFState`` with leading axes: particles [..., P, D], weights
[..., P]; every function works on the whole bank at once (the JAX package
vmaps a single-filter function). Every draw comes from the
``torch.Generator`` passed in, which lives on the bank's device. The
keyword arguments ``_eps`` / ``_noise`` / ``_u0`` replace a draw with
numbers made elsewhere: the tests use them to feed this package and the
JAX package the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mpc_cbf_torch.ops.geometry import inside_fov

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PFParams:
    num_particles: int = 256
    dt: float = 0.2  # particle_filter.cpp:19 (hard-coded dt)


@dataclasses.dataclass
class PFState:
    """particles [..., P, D]; weights [..., P] (normalized)."""

    particles: Tensor
    weights: Tensor


def _randn(generator: torch.Generator, shape, like: Tensor) -> Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def pf_init(generator: torch.Generator, init_state: Tensor, init_cov: Tensor,
            params: PFParams, *, _eps: Optional[Tensor] = None) -> PFState:
    """Sample P particles per filter from N(init_state, init_cov) via
    Cholesky (particle_filter.cpp:36-48). init_state [..., D]; init_cov
    [D, D] or [..., D, D]."""
    D = init_state.shape[-1]
    P = params.num_particles
    L = torch.linalg.cholesky(init_cov)
    eps = _eps if _eps is not None else _randn(generator, (*init_state.shape[:-1], P, D),
                                               init_state)
    particles = init_state[..., None, :] + eps @ L.transpose(-1, -2)
    w = init_state.new_full((*init_state.shape[:-1], P), 1.0 / P)
    return PFState(particles=particles, weights=w)


def pf_predict(generator: torch.Generator, st: PFState, process_cov_chol: Tensor,
               params: PFParams, u: Optional[Tensor] = None, *,
               _noise: Optional[Tensor] = None) -> PFState:
    """x += u dt + W eps (particle_filter.cpp:63-83; W multiplies standard
    normals, so pass the reference's W matrix directly). u [..., D] is one
    drift per filter."""
    eps = _noise if _noise is not None else _randn(generator, st.particles.shape, st.particles)
    particles = st.particles + eps @ process_cov_chol.T
    if u is not None:
        particles = particles + u[..., None, :] * params.dt
    return PFState(particles=particles, weights=st.weights)


def _likelihood(particles: Tensor, measurement: Tensor, meas_cov: Tensor) -> Tensor:
    """exp(-d2/2) [..., P] of the Gaussian innovation against one
    measurement [..., D] per filter."""
    innov = particles - measurement[..., None, :]
    # inv_ex: linalg.inv would read its error flag back, and so wait for the device
    Pinv = torch.linalg.inv_ex(meas_cov).inverse
    d2 = torch.einsum("...pi,ij,...pj->...p", innov, Pinv, innov)
    return torch.exp(-0.5 * d2)


def _normalized(w: Tensor) -> Tensor:
    return w / torch.sum(w, dim=-1, keepdim=True).clamp_min(1e-30)


def pf_update(st: PFState, measurement: Tensor, meas_cov: Tensor) -> PFState:
    """Gaussian likelihood re-weighting (particle_filter.cpp:85-104)."""
    return PFState(particles=st.particles,
                   weights=_normalized(_likelihood(st.particles, measurement, meas_cov)))


def pf_resample(generator: torch.Generator, st: PFState, *,
                _u0: Optional[Tensor] = None) -> PFState:
    """Systematic resampling (replaces discrete_distribution,
    particle_filter.cpp:106-118). One uniform draw per filter; ``_u0``
    [...] stands for it, in [0, 1)."""
    P = st.weights.shape[-1]
    lead = st.weights.shape[:-1]
    cum = torch.cumsum(st.weights, dim=-1)
    cum = cum / cum[..., -1:]
    u0 = _u0 if _u0 is not None else torch.rand(
        lead, generator=generator, dtype=st.weights.dtype, device=st.weights.device)
    pts = (u0 / P)[..., None] + torch.arange(
        P, dtype=st.weights.dtype, device=st.weights.device) / P
    # the first index whose cumulative weight reaches the point, as
    # jnp.searchsorted's default side gives
    idx = torch.searchsorted(cum.contiguous(), pts.contiguous(), right=False).clamp(0, P - 1)
    particles = torch.take_along_dim(st.particles, idx[..., None], dim=-2)
    return PFState(particles=particles, weights=torch.full_like(st.weights, 1.0 / P))


def pf_estimate(st: PFState) -> Tuple[Tensor, Tensor]:
    """(mean [..., D], cov [..., D, D]). The reference estimates with the
    *unweighted* particle mean/cov post-resampling
    (particle_filter.cpp:121-125, 158-175)."""
    mean = torch.mean(st.particles, dim=-2)
    diff = st.particles - mean[..., None, :]
    P = st.particles.shape[-2]
    cov = diff.transpose(-1, -2) @ diff / (P - 1)
    return mean, cov


def process_fov_update(
    generator: torch.Generator, st: PFState, ego_pose: Tensor, neighbor_pos: Tensor,
    process_cov_chol: Tensor, meas_cov: Tensor, fov_beta: float, fov_rs: float,
    params: PFParams, weight_reduction: float = 10.0, *,
    _noise: Optional[Tensor] = None, _u0: Optional[Tensor] = None,
):
    """One estimator tick of every filter (pf_applications.cpp:8-45);
    ego_pose [..., 3] and neighbor_pos [..., >=2] give each filter its
    observer and its true target:

    1. predict,
    2. down-weight particles inside the ego FOV (negative information:
       if the target were there, we'd have seen it),
    3. if the true neighbor is visible, Gaussian measurement update,
    4. systematic resample, 5. mean/cov estimate.

    Returns (new_state, mean, cov). Branch-free: the conditional update is
    a weight blend on `visible`.

    Deliberate deviation, as in the JAX package: the reference's
    ``filter.update`` REPLACES the weights with the pure measurement
    likelihood (particle_filter.cpp:85-100), silently discarding the FOV
    down-weighting applied two lines earlier when the target is visible.
    Here the likelihood MULTIPLIES the FOV-adjusted weights (the Bayesian
    composition).
    """
    st = pf_predict(generator, st, process_cov_chol, params, _noise=_noise)

    in_fov = inside_fov(ego_pose[..., None, :], st.particles, fov_beta, fov_rs)
    w = torch.where(in_fov, st.weights / weight_reduction, st.weights)

    visible = inside_fov(ego_pose, neighbor_pos, fov_beta, fov_rs)
    w_meas = w * _likelihood(st.particles, neighbor_pos[..., :2], meas_cov)
    w = _normalized(torch.where(visible[..., None], w_meas, w))

    st = pf_resample(generator, PFState(particles=st.particles, weights=w), _u0=_u0)
    mean, cov = pf_estimate(st)
    return st, mean, cov
