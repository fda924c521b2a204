"""The port's command-line runner (mpc_cbf_torch/apps/run_sim.py) on the
CPU: every controller of the JAX runner flies, `states.json` has the
reference's schema (the JAX runner's, key for key), and the summary line has
the same fields. `--device` replaces `--platform`; its default is `cuda` and
nothing falls back to the CPU.

One deliberate difference from the JAX runner (mpc_cbf_tpu/apps/run_sim.py:95
flies `--certified` uncertified on controllers that have no certified
pipeline, without a word): the port refuses the flag there.
"""

import json

import numpy as np
import pytest
import torch

from mpc_cbf_tpu.apps import run_sim as jax_run_sim
from mpc_cbf_torch.apps import run_sim
from mpc_cbf_torch.utils import config as cfgmod
from mpc_cbf_tpu.utils import config as jcfgmod

BASE = "configs/base_config.json"
TASK = "configs/baseline/2r/rotate.json"
VARIANTS = [("connectivity",), ("connectivity", "--enable-connectivity"), ("fov",),
            ("single-shot",), ("mpc",), ("cbf-connectivity",), ("cbf-fov",), ("cbf-fov", "--pf")]


def _run(main, tmp_path, capsys, controller, *flags, runtime="0.5", device=("--device", "cpu")):
    out = tmp_path / "states.json"
    rc = main(["--base", BASE, "--task", TASK, "--controller", controller, *flags,
               "--sim-runtime", runtime, "--out", str(out), *device])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, summary, json.loads(out.read_text())


def test_controllers_are_the_jax_runners():
    assert run_sim.CONTROLLERS == jax_run_sim.CONTROLLERS


@pytest.mark.parametrize("variant", VARIANTS, ids=["+".join(v).replace("--", "") for v in VARIANTS])
def test_main_flies_every_controller_on_the_cpu(variant, tmp_path, capsys):
    rc, summary, states = _run(run_sim.main, tmp_path, capsys, *variant)
    steps = 5
    assert rc in (0, 1) and rc == (0 if summary["success"] else 1)
    assert set(summary) == {"controller", "num_robots", "steps", "success", "makespan",
                            "wall_s", "solver_success_rate", "out"}
    assert (summary["controller"], summary["num_robots"], summary["steps"]) == (variant[0], 2, steps)
    assert 0.0 <= summary["solver_success_rate"] <= 1.0
    assert set(states) == {"dt", "Ts", "robots"} and (states["dt"], states["Ts"]) == (0.1, 0.01)
    assert set(states["robots"]) == {"0", "1"}
    want = {"states", "goal"} | ({"estimates_mean", "estimates_cov"}
                                 if variant[0].startswith("cbf-") else set())
    for rec in states["robots"].values():
        assert set(rec) == want
        traj = np.asarray(rec["states"])
        assert traj.shape == (steps, 6) and np.isfinite(traj).all() and len(rec["goal"]) == 3
        if "estimates_mean" in rec:
            assert np.asarray(rec["estimates_mean"]).shape == (steps, 1, 2)
            assert np.asarray(rec["estimates_cov"]).shape == (steps, 1, 2, 2)
    # the robots moved off their starts, towards their goals
    start = np.asarray(json.load(open(TASK))["tasks"]["so"])
    moved = [np.linalg.norm(np.asarray(states["robots"][str(i)]["states"])[-1, :2] - start[i, :2])
             for i in range(2)]
    assert max(moved) > 1e-3


def test_states_json_matches_the_jax_runner(tmp_path, capsys):
    """The same schema and summary fields, and on the CBF-free MPC (a
    float32 closed loop of 5 steps) the same flight to 0.1 in every state
    entry: either package's float32 ADMM at 200 iterations sits 2e-3 to 3e-3
    in the coefficients from its own float64 solve (measured on this
    instance's first step), and the closed loop carries that on; measured
    spread 0.033 in a velocity. The float64 loops agree to 1e-6
    (tests/test_torch_cbf_sims.py)."""
    rc, summary, states = _run(run_sim.main, tmp_path, capsys, "mpc")
    jrc, jsummary, jstates = _run(jax_run_sim.main, tmp_path, capsys, "mpc",
                                  device=("--platform", "cpu"))
    assert set(summary) == set(jsummary) and set(states) == set(jstates)
    assert (rc, summary["success"], summary["steps"]) == (jrc, jsummary["success"],
                                                          jsummary["steps"])
    assert summary["solver_success_rate"] == pytest.approx(jsummary["solver_success_rate"])
    for i in ("0", "1"):
        assert set(states["robots"][i]) == set(jstates["robots"][i])
        assert states["robots"][i]["goal"] == jstates["robots"][i]["goal"]
        np.testing.assert_allclose(states["robots"][i]["states"], jstates["robots"][i]["states"],
                                   rtol=0, atol=0.1)


@pytest.mark.parametrize("controller", ["mpc", "cbf-connectivity", "cbf-fov"])
def test_certified_is_refused_outside_the_structured_impc(controller, tmp_path, capsys):
    """The JAX runner silently flies these uncertified; the port says no."""
    with pytest.raises(ValueError, match="certified"):
        _run(run_sim.main, tmp_path, capsys, controller, "--certified")


def test_certified_flies_on_a_structured_impc_controller(tmp_path, capsys):
    rc, summary, _ = _run(run_sim.main, tmp_path, capsys, "connectivity", "--certified",
                          runtime="0.2")
    assert rc in (0, 1) and 0.0 <= summary["certified_rate"] <= 1.0


def test_device_defaults_to_cuda_and_does_not_fall_back(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        _run(run_sim.main, tmp_path, capsys, "mpc", device=())
    with pytest.raises(SystemExit):                      # the JAX runner's flag is gone
        run_sim.main(["--base", BASE, "--task", TASK, "--platform", "cpu"])
    capsys.readouterr()


def test_config_copy_matches_the_jax_module():
    cfg, jcfg = cfgmod.load_config(BASE, TASK), jcfgmod.load_config(BASE, TASK)
    assert cfg == jcfg
    for name in ("parse_bezier_params", "parse_mpc_params", "parse_impc_params"):
        got, want = getattr(cfgmod, name)(cfg), getattr(jcfgmod, name)(jcfg)
        assert vars(got) == vars(want), name
    assert cfgmod.parse_cbf_distances(cfg) == jcfgmod.parse_cbf_distances(jcfg)
    assert cfgmod.parse_noise(cfg) == jcfgmod.parse_noise(jcfg)
    for got, want in zip(cfgmod.parse_tasks(cfg), jcfgmod.parse_tasks(jcfg)):
        np.testing.assert_array_equal(got, want)
    (shape, kind), (jshape, jkind) = cfgmod.parse_collision_shape(cfg), \
        jcfgmod.parse_collision_shape(jcfg)
    assert kind == jkind and np.array_equal(shape, jshape)
    with pytest.raises(ValueError):
        cfgmod.parse_collision_shape({"robot_params": {"collision_shape": {}}})
    with pytest.raises(ValueError):
        cfgmod.parse_tasks({"tasks": {"so": [[0, 0, 0]], "sf": [[0, 0, 0], [1, 1, 1]]}})
    with pytest.raises(ValueError, match="unknown controller"):
        run_sim.build_sim(cfg, "pid", 2, 10, device="cpu")
