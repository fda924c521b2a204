"""Shared inputs for the parity tests of mpc_cbf_torch against mpc_cbf_tpu.

Problems follow bench.py's recipe (bench.py:73-108,143-147), made with a
numpy generator so both packages see the same numbers.
"""

import numpy as np
import pytest
import torch

MPC_K_HOR = 16
FOV_BETA = 120.0 * np.pi / 180.0
BOX = np.array([0.1, 0.1, 0.0])


def fov_inputs(rng, batch, num_neighbors=7):
    """(pos, vel, ref, blob, mask) numpy for the fov flagship (bench.py:88-93)."""
    ang = rng.uniform(0, 2 * np.pi, (batch, num_neighbors))
    rad = rng.uniform(1.0, 3.5, (batch, num_neighbors))
    cov = np.broadcast_to(np.array([0.05, 0.0, 0.05]), (batch, num_neighbors, 3))
    blob = np.concatenate([(rad * np.cos(ang))[..., None],
                           (rad * np.sin(ang))[..., None], cov], axis=-1)
    return _common(rng, batch, blob)


def conn_inputs(rng, batch, num_neighbors=3):
    """(pos, vel, ref, blob, mask) numpy for connectivity (bench.py:103-108)."""
    ang = rng.uniform(0, 2 * np.pi, (batch, num_neighbors))
    rad = rng.uniform(2.5, 4.0, (batch, num_neighbors))
    nbr_pos = np.stack([rad * np.cos(ang), rad * np.sin(ang), np.zeros_like(rad)], -1)
    nbr_vel = rng.normal(0, 0.5, (batch, num_neighbors, 3))
    return _common(rng, batch, np.concatenate([nbr_pos, nbr_vel], -1))


def _common(rng, batch, blob):
    pos = rng.normal(0, 0.3, (batch, 3))
    vel = rng.normal(0, 0.5, (batch, 3))
    goals = rng.normal(0, 3.0, (batch, 3))
    ref = np.tile(goals[:, None, :], (1, MPC_K_HOR, 1)).reshape(batch, -1)
    mask = np.ones(blob.shape[:2], bool)
    return pos, vel, ref, blob, mask


def jax_controller(mode):
    """The JAX package's fov (8-robot, slack) or connectivity (4-robot)
    controller as bench.py builds it; "connectivity_lambda2" adds the λ₂/CLF
    rows (enable_connectivity=True)."""
    import jax.numpy as jnp
    from mpc_cbf_tpu.ops.cbf import ConnectivityCBF, FovCBF
    from mpc_cbf_tpu.controllers import (
        BezierParams, MPCParams, BezierMPCOperator, IMPCParams,
        ConnectivityIMPCCBF, FovIMPCCBF)

    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3)
    if mode == "fov":
        cbf = FovCBF(FOV_BETA, 0.3, 6.0, jnp.asarray(mpc.v_min), jnp.asarray(mpc.v_max))
        return FovIMPCCBF(op, cbf, IMPCParams(slack_mode=True), 7, box_half_extents=BOX)
    cbf = ConnectivityCBF(1.0, 4.0, jnp.asarray(mpc.v_min), jnp.asarray(mpc.v_max))
    return ConnectivityIMPCCBF(op, cbf, IMPCParams(), 3,
                               enable_connectivity=mode == "connectivity_lambda2")


def torch_controller(mode, device, dtype):
    """The port's counterpart of jax_controller."""
    from mpc_cbf_torch.ops.cbf import ConnectivityCBF, FovCBF
    from mpc_cbf_torch.controllers import (
        BezierParams, MPCParams, BezierMPCOperator, IMPCParams,
        ConnectivityIMPCCBF, FovIMPCCBF)

    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3, device=device, dtype=dtype)
    if mode == "fov":
        cbf = FovCBF(FOV_BETA, 0.3, 6.0, mpc.v_min, mpc.v_max)
        return FovIMPCCBF(op, cbf, IMPCParams(slack_mode=True), 7, box_half_extents=BOX)
    cbf = ConnectivityCBF(1.0, 4.0, mpc.v_min, mpc.v_max)
    return ConnectivityIMPCCBF(op, cbf, IMPCParams(), 3,
                               enable_connectivity=mode == "connectivity_lambda2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module's tests run, then the count it
    found. The suite runs several workers a host, and the parity tests' small
    tensors gain nothing from more threads: spinning threads of several
    workers slow each other down many times over. Autouse where imported."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
