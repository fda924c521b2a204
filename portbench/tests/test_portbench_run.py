"""Whole runs of the harness on the CPU at a tiny size: its last line, a
cell added by files alone, and ``correct`` coming out false with the timed
path broken underneath. The harness's look for a card is skipped by
handing ``main`` the CPU; without that it refuses to run here."""

import importlib.util
import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
TINY = {"scenarios": 3, "episode_steps": 3, "check_scenarios": 2, "trace_steps": 1,
        "warmup_steps": 1}
CELLS = ["conn8.fleet", "fov8.fleet"]


def harness(tmp_path: Path):
    """A copy of the benchmark with a throwaway tiny cell of each cell's
    configuration and traffic kind, added as files and BENCHMARK.json
    entries only."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = []
    for w in bench["workloads"]:
        traffic = json.loads((ROOT / "portbench" / "workloads" / f"{w['traffic']}.json").read_text())
        traffic.update(TINY)
        name = f"{w['traffic']}_tiny"
        (tmp_path / "portbench" / "workloads" / f"{name}.json").write_text(json.dumps(traffic))
        cells.append(dict(w, name=w["name"] + ".tiny", traffic=name))
    bench["workloads"] += cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [c + ".tiny" for c in m["workloads"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = importlib.util.spec_from_file_location("portbench_copy_run",
                                                  tmp_path / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, tmp_path / "BENCHMARK.json"


def last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = importlib.util.spec_from_file_location("portbench_run", ROOT / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main(["--workload", "conn8.fleet", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(tmp_path, capsys, cell, trace):
    mod, bench = harness(tmp_path)
    rc = mod.main(["--workload", cell + ".tiny", "--seed", str(2 ** 33 + 7), "--seconds", "0.1",
                   "--trace", str(trace)], device="cpu", bench_path=bench)
    out = last_line(capsys)
    assert rc == 0
    assert list(out)[-1] == "check" and {"correct", "attempted", "failed", "metrics",
                                         "device"} <= set(out)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    spec = json.loads(bench.read_text())
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
        assert set(out["metrics"]) <= {m["name"] for m in spec["per_layer"]}
    else:
        want = {m["name"] for m in spec["end_to_end"] if cell + ".tiny" in m.get("workloads", [cell + ".tiny"])}
        assert set(out["metrics"]) == want
    assert out["correct"] is True, out["check"]


def fly_unchanged(sim, simpc):
    fly = sim.fly

    def broken(coeffs, prev, fresh, *a, **k):
        _, age, has = fly(coeffs, prev, fresh, *a, **k)
        return prev, age, has
    object.__setattr__(sim, "fly", broken)


def answer(change):
    def fault(sim, simpc):
        solve = simpc.op_qp.solve

        def broken(*a, **k):
            sol = solve(*a, **k)
            return sol._replace(z=change(sol.z.clone()))
        simpc.op_qp.solve = broken
    return fault


def q_dropped(sim, simpc):
    """The solver is handed no linear cost: its answer stays feasible and
    ignores the goal."""
    solve = simpc.op_qp.solve

    def broken(q, *a, **k):
        return solve(torch.zeros_like(q), *a, **k)
    simpc.op_qp.solve = broken


def stops_early(sim, simpc):
    """The ADMM's phases run half their iterations (the IPM has no phases:
    the fault does not apply there)."""
    op = simpc.op_qp
    if not hasattr(op, "phases"):
        pytest.skip("the configuration's solver runs no ADMM phases")
    op.phases = [(n // 2,) + tuple(rest) for n, *rest in op.phases]


def half_left_out(z):
    z[::2] = 0.0
    return z


def altered(z):
    z[:, 0] += 0.1
    return z


@pytest.mark.parametrize("fault", [fly_unchanged, answer(half_left_out), answer(altered),
                                   q_dropped, stops_early],
                         ids=["state_unchanged", "half_the_batch_left_out", "answer_altered",
                              "cost_dropped", "admm_stops_early"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(tmp_path, capsys, cell, fault):
    mod, bench = harness(tmp_path)
    rc = mod.main(["--workload", cell + ".tiny", "--seed", "5", "--seconds", "0.1", "--trace", "0"],
                  device="cpu", fault=fault, bench_path=bench)
    assert rc == 0 and last_line(capsys)["correct"] is False
