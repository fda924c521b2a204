"""The port's particle filter (mpc_cbf_torch/estimation/particle_filter.py)
against the JAX package on shared draws, in float64.

The two packages draw different numbers from the same seed, so every random
draw is made here with numpy and handed to both: to the JAX functions by
replacing `jax.random.normal` / `jax.random.uniform` for the call, to the
port through its `_eps` / `_noise` / `_u0` arguments. On the same draws the
resampled indices are equal and everything else agrees to 1e-12. The port
takes a bank of filters at once; the JAX functions take one filter and are
looped.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc_cbf_tpu.estimation import particle_filter as jpf
from mpc_cbf_torch.estimation import particle_filter as tpf
from mpc_cbf_torch.utils.convert import pf_state_from_numpy, pf_state_to_numpy

F64 = torch.float64
T = lambda a: torch.as_tensor(np.array(a), dtype=F64)
P, BANK = 64, 5
PARAMS, JPARAMS = tpf.PFParams(num_particles=P, dt=0.1), jpf.PFParams(num_particles=P, dt=0.1)
KEY = jax.random.PRNGKey(0)


class _Draws:
    """Stands in for jax.random inside one JAX call: hands out the numpy
    draws queued for it."""

    def __init__(self, monkeypatch, normal=(), uniform=()):
        normal, uniform = list(normal), list(uniform)
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=None: jnp.asarray(normal.pop(0)).reshape(shape))
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape=(), dtype=None: jnp.asarray(uniform.pop(0)).reshape(shape))


def _bank(rng):
    particles = rng.normal(0, 1.0, (BANK, P, 2)) + rng.normal(0, 2.0, (BANK, 1, 2))
    w = rng.uniform(0.1, 1.0, (BANK, P))
    return particles, w / w.sum(-1, keepdims=True)


def test_init_predict_update_estimate_match_jax(monkeypatch):
    rng = np.random.default_rng(0)
    x0 = rng.normal(0, 2.0, (BANK, 2))
    cov0 = np.array([[0.25, 0.05], [0.05, 0.16]])
    eps, noise = rng.normal(size=(2, BANK, P, 2))
    W = np.array([[0.1, 0.0], [0.02, 0.08]])
    u = rng.normal(size=(BANK, 2))
    meas, meas_cov = x0 + 0.1, np.array([[0.02, 0.005], [0.005, 0.03]])

    st = tpf.pf_init(None, T(x0), T(cov0), PARAMS, _eps=T(eps))
    assert st.particles.shape == (BANK, P, 2) and st.weights.shape == (BANK, P)
    st_p = tpf.pf_predict(None, st, T(W), PARAMS, u=T(u), _noise=T(noise))
    st_u = tpf.pf_update(st_p, T(meas), T(meas_cov))
    mean, cov = tpf.pf_estimate(st_u)
    for b in range(BANK):
        _Draws(monkeypatch, normal=[eps[b], noise[b]])
        jst = jpf.pf_init(KEY, jnp.asarray(x0[b]), jnp.asarray(cov0), JPARAMS)
        np.testing.assert_allclose(st.particles[b].numpy(), np.asarray(jst.particles),
                                   rtol=0, atol=1e-12)
        jst_p = jpf.pf_predict(KEY, jst, jnp.asarray(W), JPARAMS, u=jnp.asarray(u[b]))
        np.testing.assert_allclose(st_p.particles[b].numpy(), np.asarray(jst_p.particles),
                                   rtol=0, atol=1e-12)
        jst_u = jpf.pf_update(jst_p, jnp.asarray(meas[b]), jnp.asarray(meas_cov))
        np.testing.assert_allclose(st_u.weights[b].numpy(), np.asarray(jst_u.weights),
                                   rtol=1e-10, atol=1e-15)
        jmean, jcov = jpf.pf_estimate(jst_u)
        np.testing.assert_allclose(mean[b].numpy(), np.asarray(jmean), rtol=0, atol=1e-12)
        np.testing.assert_allclose(cov[b].numpy(), np.asarray(jcov), rtol=0, atol=1e-12)


@pytest.mark.parametrize("u0_kind", ["random", "edges"])
def test_resample_matches_jax(monkeypatch, u0_kind):
    """searchsorted takes the first index whose cumulative weight reaches the
    point (jnp.searchsorted's default side); u0 = 0 and a u0 just below 1
    are the edges."""
    rng = np.random.default_rng(1)
    particles, w = _bank(rng)
    w[0, 10:20] = 0.0                                   # a run of equal cumulative weights
    w[0] /= w[0].sum()
    u0 = rng.uniform(size=BANK) if u0_kind == "random" else \
        np.array([0.0, 1.0 - 1e-12, 0.5, 0.0, 1.0 - 1e-12])
    st = tpf.pf_resample(None, pf_state_from_numpy(particles, w, device="cpu", dtype=F64),
                         _u0=T(u0))
    got, got_w = pf_state_to_numpy(st)
    np.testing.assert_array_equal(got_w, np.full((BANK, P), 1.0 / P))
    for b in range(BANK):
        _Draws(monkeypatch, uniform=[u0[b]])
        jst = jpf.pf_resample(KEY, jpf.PFState(jnp.asarray(particles[b]), jnp.asarray(w[b])))
        np.testing.assert_array_equal(got[b], np.asarray(jst.particles))   # the same indices


def test_process_fov_update_matches_jax(monkeypatch):
    """One estimator tick of a bank whose filters see their target (inside
    the wedge), do not (behind the ego) and straddle the range."""
    rng = np.random.default_rng(2)
    ego = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, np.pi], [1.0, -1.0, 0.5],
                    [0.0, 0.0, 0.0], [2.0, 2.0, -2.0]])
    nbr = np.array([[2.0, 0.3], [2.0, 0.3], [2.5, 0.2], [3.9, 0.0], [0.5, 0.1]])
    particles = nbr[:, None, :] + rng.normal(0, 0.4, (BANK, P, 2))
    w = np.full((BANK, P), 1.0 / P)
    noise, u0 = rng.normal(size=(BANK, P, 2)), rng.uniform(size=BANK)
    proc, meas = 0.1 * np.eye(2), 0.05**2 * np.eye(2)
    beta, rs = 2.0943951023931953, 4.0

    st, mean, cov = tpf.process_fov_update(
        None, pf_state_from_numpy(particles, w, device="cpu", dtype=F64), T(ego), T(nbr),
        T(proc), T(meas), beta, rs, PARAMS, _noise=T(noise), _u0=T(u0))
    assert mean.shape == (BANK, 2) and cov.shape == (BANK, 2, 2)
    visible = []
    for b in range(BANK):
        _Draws(monkeypatch, normal=[noise[b]], uniform=[u0[b]])
        jst, jmean, jcov = jpf.process_fov_update(
            KEY, jpf.PFState(jnp.asarray(particles[b]), jnp.asarray(w[b])), jnp.asarray(ego[b]),
            jnp.asarray(nbr[b]), jnp.asarray(proc), jnp.asarray(meas), beta, rs, JPARAMS)
        np.testing.assert_allclose(st.particles[b].numpy(), np.asarray(jst.particles),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(mean[b].numpy(), np.asarray(jmean), rtol=0, atol=1e-12)
        np.testing.assert_allclose(cov[b].numpy(), np.asarray(jcov), rtol=0, atol=1e-12)
        visible.append(np.linalg.norm(np.asarray(jmean) - nbr[b]) < 0.3)
    assert visible[0] and visible[2]                    # a seen target pins the estimate


def test_own_draws_come_from_the_generator():
    """Without the test arguments every draw comes from the generator: the
    same seed gives the same bank, another seed another one."""
    x0 = torch.zeros((3, 2), dtype=F64)
    cov = 0.25 * torch.eye(2, dtype=F64)
    run = lambda seed: tpf.process_fov_update(
        torch.Generator().manual_seed(seed),
        tpf.pf_init(torch.Generator().manual_seed(seed), x0, cov, PARAMS),
        torch.zeros((3, 3), dtype=F64), x0 + 1.0, 0.1 * torch.eye(2, dtype=F64),
        0.01 * torch.eye(2, dtype=F64), 2.0, 4.0, PARAMS)[0].particles
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    assert torch.isfinite(run(3)).all()
