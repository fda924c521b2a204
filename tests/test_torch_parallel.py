"""The port's mesh, scenario sharding and multi-process helpers
(mpc_cbf_torch/parallel/{mesh,distributed}.py, sim.py::sharded_rollout)
against the JAX package's, on the CPU.

- Mesh shapes over 8 CPU devices (the JAX tests' 8-device virtual mesh),
  and the slices each sharding gives a device.
- sharded_rollout of tests/test_parallel.py's 8 scenarios (2-robot
  connectivity, dense ADMM, 120 iterations, zero noise, 5 steps) over 8 CPU
  devices: within atol 1e-4 of the JAX sharded_rollout (the bar of
  tests/test_torch_sim.py; measured max |Δ| in the docstring), and equal
  to the port's unsharded rollout of the same batch to 1e-9 (float64 lanes
  solved in batches of 2 and of 16 round differently: 1.1e-12 measured).
  One device: exactly ``sim.rollout``.
- global_mesh / host_scenarios_to_global in one process.
- Two gloo processes (tests/torch_distributed_worker.py, torch only), each
  with 4 scenarios: the gathered result of each equals the JAX package's
  single-process reference of tests/test_distributed_multiprocess.py
  within atol 1e-10 (float64 through the dense ADMM in both).
"""

import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc_cbf_tpu.types import State as JState
from mpc_cbf_tpu.parallel import (
    MultiAgentSim as JSim, make_mesh as j_make_mesh, sharded_rollout as j_sharded_rollout)

from mpc_cbf_torch.types import State
from mpc_cbf_torch.parallel import (
    MultiAgentSim, make_mesh, scenario_agent_sharding, scenario_sharding, sharded_rollout)
from mpc_cbf_torch.parallel import distributed
from torch_parity_cases import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
CPU8 = ["cpu"] * 8
F64 = torch.float64


def test_mesh_shapes_over_eight_cpu_devices():
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape == {"scenario": 8, "agent": 1} and mesh.size == 8
    assert mesh.axis_names == tuple(j_make_mesh().axis_names)
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    assert make_mesh(agent=2, devices=CPU8).devices.shape == (4, 2)
    assert make_mesh(2, 4, devices=CPU8).shape == {"scenario": 2, "agent": 4}
    with pytest.raises(ValueError):
        make_mesh(3, 2, devices=CPU8)

    m = make_mesh(4, 2, devices=CPU8)
    shards = scenario_sharding(m).shards((8, 2, 3))
    assert len(shards) == 8
    assert [s[2] for s in shards[:4]] == [(slice(0, 2),)] * 2 + [(slice(2, 4),)] * 2
    both = scenario_agent_sharding(m).shards((8, 4, 3))
    assert both[3][2] == (slice(2, 4), slice(2, 4))
    with pytest.raises(ValueError):
        scenario_sharding(m).shards((6, 2, 3))


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def _sims():
    """tests/test_parallel.py's _sim() in both packages, float64."""
    from mpc_cbf_tpu.ops.cbf import ConnectivityCBF as JConnCBF
    from mpc_cbf_tpu.ops.qp import ADMMConfig as JADMMConfig
    from mpc_cbf_tpu import controllers as jc
    from mpc_cbf_torch.ops.cbf import ConnectivityCBF
    from mpc_cbf_torch.ops.qp import ADMMConfig
    from mpc_cbf_torch import controllers as tc

    jm, m = jc.MPCParams(), tc.MPCParams()
    jctrl = jc.ConnectivityIMPCCBF(
        jc.BezierMPCOperator(jc.BezierParams(), jm, dim=3),
        JConnCBF(0.8, 4.0, jnp.asarray(jm.v_min), jnp.asarray(jm.v_max)),
        jc.IMPCParams(impc_iter=1), 1, solver=JADMMConfig(iters=120))
    op = tc.BezierMPCOperator(tc.BezierParams(), m, dim=3, device="cpu", dtype=F64)
    ctrl = tc.ConnectivityIMPCCBF(op, ConnectivityCBF(0.8, 4.0, m.v_min, m.v_max),
                                  tc.IMPCParams(impc_iter=1), 1, solver=ADMMConfig(iters=120))
    return JSim(jctrl, 2), MultiAgentSim(ctrl, 2)


def _scenarios(S=8):
    """tests/test_parallel.py:55-75's scenarios."""
    rng = np.random.default_rng(0)
    base = np.array([[-1.5, 0.0, 0.0], [1.5, 0.0, 0.0]])
    inits = np.stack([base + rng.normal(0, 0.05, base.shape) for _ in range(S)])
    return inits, np.stack([-b for b in inits])


@functools.lru_cache(maxsize=None)
def _rollouts():
    sim_j, sim = _sims()
    inits, goals = _scenarios()
    init = State(torch.from_numpy(inits), torch.zeros(8, 2, 3, dtype=F64))
    res = sharded_rollout(sim, make_mesh(devices=CPU8), init, torch.from_numpy(goals), 5)
    jres = j_sharded_rollout(sim_j, j_make_mesh(), JState(pos=jnp.asarray(inits),
                                                          vel=jnp.zeros((8, 2, 3))),
                             jnp.asarray(goals), 5)
    return sim, init, goals, res, jres


def test_sharded_rollout_matches_jax():
    """Measured on the CPU: max |Δ| 1.5e-12 in positions, 6.7e-12 in
    velocities; bar 1e-4."""
    _, _, _, res, jres = _rollouts()
    assert res.traj_pos.shape == (8, 5, 2, 3) and res.success.shape == (8, 5, 2)
    np.testing.assert_array_equal(res.success.numpy(), np.asarray(jres.success))
    np.testing.assert_allclose(res.traj_pos.numpy(), np.asarray(jres.traj_pos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.traj_vel.numpy(), np.asarray(jres.traj_vel), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.states.pos.numpy(), np.asarray(jres.states.pos), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(res.coeffs.numpy(), np.asarray(jres.coeffs), rtol=0, atol=1e-4)


def test_sharded_rollout_matches_the_unsharded_rollout():
    sim, init, goals, res, _ = _rollouts()
    whole = sim.rollout(init, torch.from_numpy(goals), 5)
    for got, want in ((res.traj_pos, whole.traj_pos), (res.traj_vel, whole.traj_vel),
                      (res.coeffs, whole.coeffs), (res.states.pos, whole.states.pos)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-9)
    torch.testing.assert_close(res.success, whole.success, rtol=0, atol=0)


def test_one_device_is_exactly_rollout():
    sim = MultiAgentSim(_sims()[1].controller, 2, noise_pos_std=0.01)
    inits, goals = _scenarios(3)
    init = State(torch.from_numpy(inits), torch.zeros(3, 2, 3, dtype=F64))
    g = torch.from_numpy(goals)
    one = sharded_rollout(sim, make_mesh(devices=["cpu"]), init, g, 2)
    ref = sim.rollout(init, g, 2)
    for a, b in zip((one.traj_pos, one.traj_vel, one.success, one.coeffs),
                    (ref.traj_pos, ref.traj_vel, ref.success, ref.coeffs)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a noisy batch over 3 rows: row k draws from a generator seeded k
    three = sharded_rollout(sim, make_mesh(devices=["cpu"] * 3), init, g, 2)
    row1 = sim.rollout(State(init.pos[1:2], init.vel[1:2]), g[1:2], 2,
                       torch.Generator().manual_seed(1))
    torch.testing.assert_close(three.traj_pos[1:2], row1.traj_pos, rtol=0, atol=0)


def test_sharded_rollout_refuses_a_mesh_of_one_process_in_a_group(monkeypatch):
    """In a group of 2, a mesh whose rows all belong to this process (make_mesh)
    would run every scenario here and gather each twice: refused."""
    import mpc_cbf_torch.parallel.sim as sim_mod

    monkeypatch.setattr(sim_mod, "_world", lambda: (2, 0))
    sim = _sims()[1]
    inits, goals = _scenarios(2)
    init = State(torch.from_numpy(inits), torch.zeros(2, 2, 3, dtype=F64))
    with pytest.raises(ValueError, match="rank order"):
        sharded_rollout(sim, make_mesh(devices=["cpu"] * 2), init, torch.from_numpy(goals), 1)


def test_global_mesh_and_host_scenarios_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    distributed.init_distributed()                 # no cluster: a no-op
    assert not torch.distributed.is_initialized()
    mesh = distributed.global_mesh()
    assert mesh.shape == {"scenario": 1, "agent": 1}
    assert mesh.devices[0, 0] == torch.device("cpu") and mesh.processes[0, 0] == 0
    with pytest.raises(ValueError):
        distributed.global_mesh(agent=2)
    batch = {"pos": torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3),
             "ok": torch.ones(8, dtype=torch.bool)}
    g = distributed.host_scenarios_to_global(mesh, batch)
    assert set(g) == {"pos", "ok"}
    torch.testing.assert_close(g["pos"], batch["pos"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="num_processes"):
        distributed.init_distributed("localhost:1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_rollout_matches_jax_single_process(tmp_path):
    from test_distributed_multiprocess import _single_process_reference

    port = _free_port()
    outs = [tmp_path / f"w{i}.npz" for i in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"              # small tensors; see one_torch_thread
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_distributed_worker.py"),
                               str(i), "2", str(port), str(outs[i])],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              cwd=str(REPO))
             for i in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            logs.append(out.decode(errors="replace"))
        for i, p in enumerate(procs):
            assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    ref = _single_process_reference()                     # [8, T, A, 3], JAX
    starts = np.stack([[[-1.5, 0.1 * s, 0.0], [1.5, -0.1 * s, 0.0]] for s in range(8)])
    for o in outs:
        d = np.load(o)
        assert tuple(d["mesh_rows"]) == (2, 1)
        np.testing.assert_array_equal(d["starts"], starts)     # gathered in rank order
        np.testing.assert_allclose(d["traj_pos"], ref, rtol=0, atol=1e-10)
