"""The port's checkpoint/resume (mpc_cbf_torch/utils/checkpoint.py) against
the JAX package's, on the CPU.

- Checkpointer: round trip, ``keep``, the structure check, and the same tree
  saved by both packages giving equal ``leaf_i`` arrays (exactly).
- checkpointed_rollout: the 2-robot connectivity sim of
  tests/test_checkpoint.py (ADMM iterations 120) at zero noise, 20 steps in
  segments of 8, dense and structured, against the JAX package's; float64;
  per-step solver success equal, trajectories within atol 1e-4, the bar of
  tests/test_torch_sim.py (measured max |Δ| in the test's docstring).
- A crash and resume: bitwise equal to the uninterrupted checkpointed run,
  also with state noise, through the saved generator state.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc_cbf_tpu.types import State as JState
from mpc_cbf_tpu.utils.checkpoint import (
    Checkpointer as JCheckpointer, checkpointed_rollout as j_checkpointed_rollout)

from mpc_cbf_torch.types import State
from mpc_cbf_torch.utils.checkpoint import Checkpointer, checkpointed_rollout
from mpc_cbf_torch.utils import convert
from torch_parity_cases import one_torch_thread  # noqa: F401  (autouse)

F64 = torch.float64
STARTS = np.array([[-1.5, 0.3, 0.0], [1.5, -0.3, 0.0]])
GOALS = np.array([[1.5, 0.3, 0.0], [-1.5, -0.3, 0.0]])


def test_checkpointer_roundtrip_and_keep(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(4.0), "b": (torch.ones(2, 2), torch.tensor(3))}
    for step, scale in ((10, 1), (20, 2), (30, 3)):
        ck.save(step, {"a": tree["a"] * scale, "b": (tree["b"][0] * scale, tree["b"][1] * scale)})
    assert ck.steps() == [20, 30]                  # keep=2 removes the oldest
    step, restored = ck.restore_latest(tree)
    assert step == 30
    torch.testing.assert_close(restored["a"], 3 * torch.arange(4.0), rtol=0, atol=0)
    assert isinstance(restored["b"], tuple) and int(restored["b"][1]) == 9
    # each leaf takes its template's dtype
    _, as64 = ck.restore_latest({"a": torch.zeros(4, dtype=F64),
                                 "b": (torch.zeros(2, 2), torch.tensor(0))})
    assert as64["a"].dtype == F64 and as64["b"][1].dtype == torch.int64
    assert Checkpointer(str(tmp_path / "empty")).restore_latest(tree) == (None, None)


def test_restore_refuses_another_structure(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(3), "b": torch.zeros(2)})
    for other in ({"a": torch.zeros(3)}, {"a": torch.zeros(3), "c": torch.zeros(2)},
                  {"a": torch.zeros(3), "b": (torch.zeros(2),)}):
        with pytest.raises(ValueError, match="structure mismatch"):
            ck.restore(1, other)


def test_leaves_equal_the_jax_package(tmp_path):
    """dict keys sorted, tuples/lists/NamedTuples/State in order, None as no
    leaf: the same leaf_i arrays as jax.tree.flatten gives."""
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.normal(size=s) for s in ((4,), (2, 3), (3,), (3,)))
    tree_t = {"z": torch.from_numpy(a), "a": [torch.from_numpy(b), None, 7],
              "m": (State(torch.from_numpy(c), torch.from_numpy(d)), np.int32(5))}
    tree_j = {"z": jnp.asarray(a), "a": [jnp.asarray(b), None, 7],
              "m": (JState(pos=jnp.asarray(c), vel=jnp.asarray(d)), np.int32(5))}
    Checkpointer(str(tmp_path / "t")).save(3, tree_t)
    JCheckpointer(str(tmp_path / "j")).save(3, tree_j)
    with np.load(tmp_path / "t" / "ckpt_00000003.npz") as ft, \
            np.load(tmp_path / "j" / "ckpt_00000003.npz") as fj:
        names = sorted(k for k in fj.files if k.startswith("leaf_"))
        assert names == sorted(k for k in ft.files if k.startswith("leaf_"))
        assert len(names) == 6
        for k in names:
            assert ft[k].dtype == fj[k].dtype, k
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


def _sims(structured: bool):
    """(JAX sim, port sim): tests/test_checkpoint.py's 2-robot connectivity
    sim, ADMM iterations 120, float64."""
    from mpc_cbf_tpu.ops.cbf import ConnectivityCBF as JConnCBF
    from mpc_cbf_tpu.ops.qp import ADMMConfig as JADMMConfig
    from mpc_cbf_tpu.ops.qp.structured import StructuredConfig as JStructuredConfig
    from mpc_cbf_tpu.controllers import (
        BezierParams as JBP, MPCParams as JMP, BezierMPCOperator as JOp, IMPCParams as JIP,
        ConnectivityIMPCCBF as JConn)
    from mpc_cbf_tpu.parallel import MultiAgentSim as JSim
    from mpc_cbf_torch.ops.cbf import ConnectivityCBF
    from mpc_cbf_torch.ops.qp import ADMMConfig, StructuredConfig
    from mpc_cbf_torch.controllers import (
        BezierParams, MPCParams, BezierMPCOperator, IMPCParams, ConnectivityIMPCCBF)
    from mpc_cbf_torch.parallel import MultiAgentSim

    jm, m = JMP(), MPCParams()
    ctrl_j = JConn(JOp(JBP(), jm, dim=3), JConnCBF(1.0, 4.0, jnp.asarray(jm.v_min),
                                                   jnp.asarray(jm.v_max)),
                   JIP(), 1, solver=JADMMConfig(iters=120))
    op = BezierMPCOperator(BezierParams(), m, dim=3, device="cpu", dtype=F64)
    ctrl_t = ConnectivityIMPCCBF(op, ConnectivityCBF(1.0, 4.0, m.v_min, m.v_max), IMPCParams(),
                                 1, solver=ADMMConfig(iters=120))
    if not structured:
        return JSim(ctrl_j, 2), MultiAgentSim(ctrl_t, 2)
    sim_j = JSim(ctrl_j, 2, structured=True,
                 solver_cfg=JStructuredConfig(iters=120, use_pallas=False))
    sim_t = MultiAgentSim(ctrl_t, 2, structured=True, solver_cfg=StructuredConfig(iters=120))
    # the JAX ADMM operator holds its constants in float32 whatever the input
    # dtype: the port takes them over so both run the same float64 loop
    op_j = sim_j._structured_impc().op_qp
    convert.set_structured_constants(
        sim_t._structured_impc().op_qp, D=np.asarray(op_j.D), E_s=np.asarray(op_j.E_s),
        gamma=op_j.gamma, Pb=np.asarray(op_j.Pb), A_sb=np.asarray(op_j.A_sb),
        phases=[(n, np.asarray(M), np.asarray(r), rd) for n, M, r, rd in op_j.phases])
    return sim_j, sim_t


def _init():
    return State(torch.from_numpy(STARTS.copy()), torch.zeros(2, 3, dtype=F64)), \
        torch.from_numpy(GOALS.copy())


@pytest.mark.parametrize("structured", [False, True], ids=["dense", "structured"])
def test_checkpointed_rollout_matches_jax(structured, tmp_path):
    """20 steps in segments of 8, 8, 4 at zero noise, then a fresh call
    with 30 steps runs the remaining 10 in both packages. Measured on the
    CPU, max |Δ| of positions / velocities: 2.7e-12 / 5.0e-12 (dense),
    1.5e-14 / 2.3e-14 (structured); bar 1e-4."""
    sim_j, sim_t = _sims(structured)
    init, goals = _init()
    (tp, tv, sc), final = checkpointed_rollout(sim_t, init, goals, 20, torch.Generator(),
                                               Checkpointer(str(tmp_path / "t")), every=8)
    jinit = JState(pos=jnp.asarray(STARTS), vel=jnp.zeros((2, 3)))
    jck = JCheckpointer(str(tmp_path / "j"))
    (jtp, jtv, jsc), jfinal = j_checkpointed_rollout(sim_j, jinit, jnp.asarray(GOALS), 20,
                                                     jax.random.PRNGKey(0), jck, every=8)
    assert tp.shape == (20, 2, 3) and sc.shape == (20, 2)
    np.testing.assert_array_equal(sc.numpy(), jsc)
    np.testing.assert_allclose(tp.numpy(), jtp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), jtv, rtol=0, atol=1e-4)
    np.testing.assert_allclose(final.pos.numpy(), np.asarray(jfinal.pos), rtol=0, atol=1e-4)
    assert Checkpointer(str(tmp_path / "t")).steps()[-1] == 20 == jck.steps()[-1]

    (tp2, _, _), _ = checkpointed_rollout(sim_t, init, goals, 30, torch.Generator(),
                                          Checkpointer(str(tmp_path / "t")), every=8)
    (jtp2, _, _), _ = j_checkpointed_rollout(sim_j, jinit, jnp.asarray(GOALS), 30,
                                             jax.random.PRNGKey(0), jck, every=8)
    assert tp2.shape[0] == 10 == jtp2.shape[0]
    np.testing.assert_allclose(tp2.numpy(), jtp2, rtol=0, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _noisy_sim():
    from mpc_cbf_torch.parallel import MultiAgentSim

    _, sim = _sims(False)
    return MultiAgentSim(sim.controller, 2, noise_pos_std=0.01, noise_vel_std=0.01)


@pytest.mark.parametrize("noisy", [False, True], ids=["noise-free", "noisy"])
def test_resume_is_bitwise_the_uninterrupted_run(noisy, tmp_path):
    """Steps 0-12 in segments of 4, a crash, a fresh call to 12: the same
    bits as one checkpointed call of 12 steps (the noisy run through the
    generator state of the snapshot)."""
    sim = _noisy_sim() if noisy else _sims(False)[1]
    init, goals = _init()
    gen = lambda: torch.Generator().manual_seed(7)
    (tp, tv, sc), final = checkpointed_rollout(sim, init, goals, 12, gen(),
                                               Checkpointer(str(tmp_path / "full")), every=4)
    ck = Checkpointer(str(tmp_path / "crash"))
    (tp_a, _, _), _ = checkpointed_rollout(sim, init, goals, 8, gen(), ck, every=4)
    # a fresh generator: the snapshot's state replaces it
    (tp_b, tv_b, sc_b), final_b = checkpointed_rollout(sim, init, goals, 12,
                                                       torch.Generator().manual_seed(99), ck,
                                                       every=4)
    assert tp_b.shape[0] == 4
    torch.testing.assert_close(torch.cat([tp_a, tp_b]), tp, rtol=0, atol=0)
    torch.testing.assert_close(tv_b, tv[8:], rtol=0, atol=0)
    torch.testing.assert_close(sc_b, sc[8:], rtol=0, atol=0)
    torch.testing.assert_close(final_b.pos, final.pos, rtol=0, atol=0)
    # nothing left to run
    assert checkpointed_rollout(sim, init, goals, 12, gen(), ck, every=4)[0] is None
    if noisy:    # the noise really comes from the generator
        (tp_c, _, _), _ = checkpointed_rollout(sim, init, goals, 4,
                                               torch.Generator().manual_seed(8),
                                               Checkpointer(str(tmp_path / "other")), every=4)
        assert not torch.equal(tp_c, tp[:4])
