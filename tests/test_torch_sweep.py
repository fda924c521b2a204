"""The port's scenario sweep (mpc_cbf_torch/apps/sweep.py) against the JAX
package's on the CPU: run_cell at team sizes 2 and 3, 2 seeds, 10 steps of
the connectivity controller on configs/base_config.json with the state
noise off (the two packages draw noise from different generators). Same
success, success_ref and makespan per seed; min_separation within 1e-3
(both fly float32 ADMM iterates, which differ by rounding).

The JAX sweep shards the scenario axis over every device of its mesh; the
8-device test mesh does not divide 2 seeds, so its mesh is cut to one
device here (on one device sharded_rollout is the batched rollout, which is
what the port runs).
"""

import json

import jax
import pytest
import torch

import mpc_cbf_tpu.parallel as jparallel
from mpc_cbf_tpu.apps import sweep as jsweep
from mpc_cbf_torch.apps import sweep
from mpc_cbf_torch.utils import config as cfgmod

BASE = "configs/base_config.json"


def _cfg():
    cfg = cfgmod.load_config(BASE)
    cfg["physical_limits"] = dict(cfg["physical_limits"], pos_std=0.0, vel_std=0.0)
    return cfg


@pytest.fixture
def one_device_mesh(monkeypatch):
    make = jparallel.make_mesh
    monkeypatch.setattr(jparallel, "make_mesh",
                        lambda scenario=None, agent=1: make(1, 1, devices=jax.devices()[:1]))


@pytest.mark.parametrize("R", [2, 3])
def test_run_cell_matches_jax(R, one_device_mesh):
    rows = sweep.run_cell(_cfg(), "connectivity", R, 2, 10, 200, device=torch.device("cpu"))
    jrows = jsweep.run_cell(_cfg(), "connectivity", R, 2, 10, 200)
    assert len(rows) == len(jrows) == 2
    for row, jrow in zip(rows, jrows):
        assert set(row) == set(jrow)
        for key in ("controller", "num_robots", "seed", "fov", "slack_decay", "steps",
                    "success", "makespan", "success_ref", "makespan_ref"):
            assert row[key] == jrow[key], key
        assert row["min_separation"] == pytest.approx(jrow["min_separation"], abs=1e-3)
        assert row["final_goal_dist_max"] == pytest.approx(jrow["final_goal_dist_max"], abs=1e-3)
        assert row["solver_success_rate"] == pytest.approx(jrow["solver_success_rate"], abs=0.05)


def test_main_writes_the_grid(tmp_path, capsys):
    out = tmp_path / "sweep.jsonl"
    rc = sweep.main(["--base", BASE, "--sizes", "2", "--seeds", "2", "--controller", "fov",
                     "--fovs", "120", "360", "--sim-runtime", "0.3", "--out", str(out),
                     "--device", "cpu"])
    assert rc == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["fov"], r["seed"]) for r in rows] == [(120.0, 0), (120.0, 1), (360.0, 0), (360.0, 1)]
    assert all(r["steps"] == 3 and r["controller"] == "fov" for r in rows)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("R=2 fov=120: ") and printed[-1] == str(out)


def test_main_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        sweep.main(["--base", BASE, "--sizes", "2"])


def test_run_size_is_run_cell_as_in_the_jax_package():
    assert sweep.run_size is sweep.run_cell and jsweep.run_size is jsweep.run_cell
