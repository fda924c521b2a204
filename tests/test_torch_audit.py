"""The port's failed-lane audit (mpc_cbf_torch/apps/audit_failed_lanes.py)
against the JAX package's script (scripts/audit_failed_lanes.py), on the CPU.

The script runs in this process as written, with three things watched: its
numpy generator (the draws it makes), its StructuredIPM (replaced by a
stand-in that records the QPs it is handed and reports a fixed list of lanes
as failed, so the script assembles those lanes) and its oracle call
(recorded, then run). Against that:
- the port's draw() gives the script's draws, bit for bit (seed 0);
- the port's structured QPs of iteration 0 (cost, shared bounds, dynamic
  rows) equal the script's within 1e-5, relative and absolute (both
  float32; the cost vector reaches 5e3, where one float32 step is 5e-4);
- the port's dense QPs of the listed lanes (``assemble``) equal the
  script's within the same 1e-5, and the oracle's statuses on them are
  equal.
Then the port's whole audit at 256 lanes on the CPU, through the f32 IPM.
"""

import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import mpc_cbf_tpu.ops.qp.ipm as jipm
import mpc_cbf_tpu.ops.qp.oracle as joracle
from mpc_cbf_torch.apps import audit_failed_lanes as audit
from torch_parity_cases import one_torch_thread  # noqa: F401  (autouse)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "audit_failed_lanes.py"
BATCH = 64
LANES = [3, 17, 42, 63]
CPU = torch.device("cpu")


class _RecordingRng:
    def __init__(self, rng, draws):
        self._rng, self._draws = rng, draws

    def __getattr__(self, name):
        fn = getattr(self._rng, name)

        def record(*a, **k):
            out = fn(*a, **k)
            self._draws.append((name, out))
            return out
        return record


def _run_script(monkeypatch):
    """Run the JAX script's main() on BATCH lanes; returns what it drew,
    what its IPM and its oracle were handed, and the oracle's answers."""
    seen = {"draws": [], "ipm": None, "oracle": None}
    spec = importlib.util.spec_from_file_location("jax_audit_failed_lanes_script", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    np_proxy = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                        if not k.startswith("__")})
    np_proxy.random = types.SimpleNamespace(
        default_rng=lambda seed: _RecordingRng(np.random.default_rng(seed), seen["draws"]))
    monkeypatch.setattr(mod, "np", np_proxy)

    class FakeIPM:
        def __init__(self, P, A_s, eq_mask, m_d, cfg):
            seen["static"] = (np.asarray(P), np.asarray(A_s), np.asarray(eq_mask), m_d)

        def solve(self, *args):
            seen["ipm"] = [np.asarray(a) for a in args]
            pri = np.zeros(BATCH)
            pri[LANES] = 1.0
            return types.SimpleNamespace(pri_res=pri)

    real_oracle = joracle.solve_oracle_batch

    def oracle(*qp):
        seen["oracle"] = [np.asarray(a) for a in qp]
        seen["oracle_out"] = real_oracle(*qp)
        return seen["oracle_out"]

    monkeypatch.setattr(jipm, "StructuredIPM", FakeIPM)
    monkeypatch.setattr(joracle, "solve_oracle_batch", oracle)
    monkeypatch.setattr(sys, "argv", ["audit_failed_lanes.py", str(BATCH)])
    mod.main()
    return seen


@pytest.fixture(scope="module")
def script_run():
    mp = pytest.MonkeyPatch()
    try:
        yield _run_script(mp)
    finally:
        mp.undo()


def test_draws_are_the_scripts(script_run):
    d = audit.draw(BATCH)
    names = [n for n, _ in script_run["draws"]]
    assert names == ["uniform", "uniform", "normal", "normal", "normal"]
    ang, rad, pos, vel, goals = (a for _, a in script_run["draws"])
    np.testing.assert_array_equal(d["nbr"][..., 0], rad * np.cos(ang))
    np.testing.assert_array_equal(d["nbr"][..., 1], rad * np.sin(ang))
    np.testing.assert_array_equal(d["nbr"][..., 2:], np.broadcast_to([0.05, 0.0, 0.05],
                                                                    (BATCH, 7, 3)))
    for got, want in ((d["pos"], pos), (d["vel"], vel), (d["goals"], goals)):
        np.testing.assert_array_equal(got, want)
    assert d["mask"].all() and d["mask"].shape == (BATCH, 7)


def _port():
    ctrl = audit.build_controller(CPU)
    return ctrl, audit.lane_inputs(ctrl, audit.draw(BATCH))


def test_structured_qps_match_the_scripts(script_run):
    ctrl, (cur, ref, nbr, mask) = _port()
    P, A_s, eq, m_d = script_run["static"]
    P_t, A_s_t, eq_t = ctrl.static_parts()
    np.testing.assert_allclose(P_t, P, rtol=0, atol=1e-5)
    np.testing.assert_allclose(A_s_t, A_s, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(eq_t, eq)
    assert ctrl.m_dynamic == m_d
    pred, active = audit._iteration0(ctrl, cur)
    ours = [ctrl.cost_vector(cur, ref, nbr, mask), *ctrl.shared_bounds(cur),
            *ctrl.dynamic_rows(cur, nbr, mask, pred, active)]
    for name, got, want in zip(("q", "lb_s", "ub_s", "A_d", "lb_d", "ub_d"), ours,
                               script_run["ipm"]):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=name)


def test_dense_qps_and_oracle_statuses_match_the_scripts(script_run):
    ctrl, args = _port()
    qp = audit.dense_qps(ctrl, *args, LANES)
    for name, got, want in zip(("P", "q", "A", "lb", "ub"), qp, script_run["oracle"]):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy().astype(np.float64), want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    out = audit.audit(qp)
    np.testing.assert_array_equal(out["status"], script_run["oracle_out"][1])
    assert sum(out["status_counts"].values()) == len(LANES)


def test_audit_runs_end_to_end_on_the_cpu(capsys):
    out = audit.run(256, CPU)
    assert out["batch"] == 256 and out["failed"] == len(out["failed_lanes"])
    assert out["usable"] == 1 - out["failed"] / 256 and out["usable"] >= 0.98
    if out["failed"]:
        assert sum(out["status_counts"].values()) == out["failed"]
    assert audit.main(["8", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("batch=8 usable=")


def test_audit_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        audit.main(["8"])                                    # default: the card
