"""The port's experiment apps (mpc_cbf_torch/apps/{statistics,
generate_instances, plot_results}.py) against the JAX package's, on the CPU.

statistics: `aggregate` and `panel_grid` equal to the JAX package's (exact:
both are numpy on the same rows) on the rows of tests/test_tooling.py, on
rows with fov / slack-decay axes and success_ref, and on rows written by the
port's `sweep.main --device cpu`. generate_instances: the files of the JAX
app for the same argv, byte for byte. plot_results: a PNG of more than 1 kB
and a GIF from a `states.json` of the port's `run_sim`. matplotlib is
imported by the plotting functions only.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

from mpc_cbf_tpu.apps import generate_instances as jgen
from mpc_cbf_tpu.apps import statistics as jstats
from mpc_cbf_torch.apps import generate_instances, plot_results, run_sim, statistics, sweep
from torch_parity_cases import one_torch_thread  # noqa: F401  (autouse)

BASE = "configs/base_config.json"


def _rows():
    """tests/test_tooling.py's rows."""
    rows = []
    for R in (2, 4):
        for s in range(4):
            rows.append({"controller": "connectivity", "num_robots": R, "seed": s,
                         "success": s != 0 or R == 2,
                         "makespan": 40.0 + s if (s != 0 or R == 2) else float("inf")})
    return rows


def _grid_rows():
    """Rows over two controllers, fov and slack-decay axes, with and
    without success_ref, makespans all inf in one cell."""
    rng = np.random.default_rng(3)
    rows = []
    for ctrl in ("fov", "single-shot"):
        for fov in (120.0, 360.0):
            for decay in (None, 0.1):
                for R in (3, 5):
                    for s in range(5):
                        ok = bool(rng.random() < 0.7) and not (fov == 120.0 and R == 5)
                        row = {"controller": ctrl, "num_robots": R, "seed": s, "fov": fov,
                               "slack_decay": decay, "success": ok,
                               "makespan": float(rng.integers(30, 60)) if ok else float("inf")}
                        if ctrl == "fov":
                            row["success_ref"] = ok or bool(rng.random() < 0.5)
                        rows.append(row)
    return rows


def _assert_summary_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], float) and np.isnan(w[k]):
                assert np.isnan(g[k]), k
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("rows", [_rows(), _grid_rows()], ids=["test_tooling", "grid"])
def test_aggregate_and_panel_grid_match_jax(rows, tmp_path):
    p = tmp_path / "sweep.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert statistics.load_rows(str(p)) == jstats.load_rows(str(p))
    summary = statistics.aggregate(statistics.load_rows(str(p)))
    _assert_summary_equal(summary, jstats.aggregate(jstats.load_rows(str(p))))
    assert statistics.panel_grid(summary) == jstats.panel_grid(summary)


def test_statistics_on_the_ports_sweep_rows(tmp_path, capsys):
    out = tmp_path / "sweep.jsonl"
    assert sweep.main(["--base", BASE, "--sizes", "2", "3", "--seeds", "2", "--controller",
                       "connectivity", "--sim-runtime", "0.3", "--out", str(out),
                       "--device", "cpu"]) == 0
    rows = statistics.load_rows(str(out))
    summary = statistics.aggregate(rows)
    _assert_summary_equal(summary, jstats.aggregate(rows))
    assert [(s["num_robots"], s["n"]) for s in summary] == [(2, 2), (3, 2)]
    for s in summary:
        cell = [r for r in rows if r["num_robots"] == s["num_robots"]]
        assert s["success_rate"] == np.mean([r["success"] for r in cell])
        assert s["success_ref_rate"] == np.mean([r["success_ref"] for r in cell])
    png = tmp_path / "stats.png"
    capsys.readouterr()
    assert statistics.main(["--results", str(out), "--plot", str(png)]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].split() == ["controller", "fov", "decay", "R", "n", "strict", "ref",
                                  "makespan", "ci95"]
    assert len(printed) == 4 and printed[-1] == str(png) and png.stat().st_size > 1000


ARGVS = [["--kind", k, "-n", "4", "-r", "3"] for k in sorted(generate_instances.KINDS)] + \
    [["--kind", "random", "-n", "6", "--seed", "5"], ["--baseline-dir", "{dir}/baseline"]]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a[:2]) + (a[3] if len(a) > 3 else "")
                                              for a in ARGVS])
def test_generate_instances_writes_the_jax_apps_files(argv, tmp_path, capsys):
    files = {}
    for name, main in (("torch", generate_instances.main), ("jax", jgen.main)):
        d = tmp_path / name
        d.mkdir()
        args = [a.format(dir=d) for a in argv]
        if "--baseline-dir" not in argv:
            args += ["--out", str(d / "task.json")]
        assert main(args) == 0
        files[name] = {p.relative_to(d): p.read_bytes() for p in sorted(d.rglob("*.json"))}
    assert files["torch"] == files["jax"]
    assert len(files["torch"]) == (10 if "--baseline-dir" in argv else 1)
    assert generate_instances.BASELINE_SIZES == jgen.BASELINE_SIZES
    assert sorted(generate_instances.KINDS) == sorted(jgen.KINDS)


def test_plot_results_on_a_run_sim_states_file(tmp_path, capsys):
    task, states = tmp_path / "task.json", tmp_path / "states.json"
    assert generate_instances.main(["--kind", "rotate", "-n", "3", "-r", "2.0",
                                    "--out", str(task)]) == 0
    run_sim.main(["--base", BASE, "--task", str(task), "--controller", "connectivity",
                  "--sim-runtime", "1.0", "--out", str(states), "--device", "cpu"])
    traj, goals, d = plot_results.load_states(str(states))
    assert traj.shape == (10, 3, 3) and goals.shape == (3, 3) and d["dt"] == 0.1
    png, gif = tmp_path / "traj.png", tmp_path / "traj.gif"
    assert plot_results.main(["--states", str(states), "--out", str(png), "--gif", str(gif),
                              "--edges-dmax", "4.0"]) == 0
    assert png.stat().st_size > 1000 and gif.stat().st_size > 1000


def test_apps_import_without_matplotlib():
    code = ("import sys\n"
            "import mpc_cbf_torch.apps.plot_results, mpc_cbf_torch.apps.statistics\n"
            "import mpc_cbf_torch.apps.generate_instances, mpc_cbf_torch.apps.audit_failed_lanes\n"
            "import mpc_cbf_torch.deploy, mpc_cbf_torch.parallel, mpc_cbf_torch.utils.checkpoint\n"
            "assert 'matplotlib' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True)
