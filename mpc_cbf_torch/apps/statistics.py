"""Aggregate sweep results: success rates, makespan CIs, RSS panel grid
(counterpart of ``mpc_cbf_tpu/apps/statistics.py``; numpy on the host, and
matplotlib only inside ``plot``).

Reference parity: ``experiments/python/metrics/Statistics.py:24-35``
(aggregate success+makespan panels across num_robots, one panel per
(FOV, slack-decay) grid cell) + ``ComputeCI.py`` (95% CI with inf-robust
variants).

Usage:
  python -m mpc_cbf_torch.apps.statistics --results /tmp/sweep.jsonl \
      [--plot /tmp/stats.png]

The plot is a panel GRID: one column per FOV value, one row per
slack-decay value (collapsing to a single panel when the sweep had no
fov/decay axes); every panel shows success rate and makespan (95% CI)
vs team size, one line per controller.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict

import numpy as np

from mpc_cbf_torch.utils.metrics import ci95_with_inf


def load_rows(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def aggregate(rows):
    """Group by (controller, fov, slack_decay, num_robots)."""
    groups = defaultdict(list)
    for r in rows:
        groups[(r.get("controller", "?"), r.get("fov"),
                r.get("slack_decay"), r["num_robots"])].append(r)
    out = []
    def key(kv):
        ctrl, fov, decay, R = kv[0]
        return (ctrl, -1.0 if fov is None else float(fov),
                -1.0 if decay is None else float(decay), R)

    for (ctrl, fov, decay, R), g in sorted(groups.items(), key=key):
        mk = np.asarray([r["makespan"] for r in g], dtype=float)
        mean, half = ci95_with_inf(mk[None])  # row-wise API (ComputeCI parity)
        mean, half = mean[0], half[0]
        row = {
            "controller": ctrl, "fov": fov, "slack_decay": decay,
            "num_robots": R, "n": len(g),
            # strict scorer: collision-free AND final position at goal
            "success_rate": sum(r["success"] for r in g) / len(g),
            "makespan_mean": float(mean), "makespan_ci95": float(half),
        }
        # reference-faithful scorer (collision-only failure — see
        # utils.metrics.instance_success_ref); present when the sweep
        # emitted it (older JSONL files carry only the strict column)
        if all("success_ref" in r for r in g):
            row["success_ref_rate"] = sum(r["success_ref"] for r in g) / len(g)
        out.append(row)
    return out


def panel_grid(summary):
    """(fov values, decay values) spanning the grid; None-only axes
    collapse to a single row/column."""
    fovs = sorted({s["fov"] for s in summary},
                  key=lambda v: -1.0 if v is None else float(v))
    decays = sorted({s["slack_decay"] for s in summary},
                    key=lambda v: -1.0 if v is None else float(v))
    return fovs, decays


def plot(summary, path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fovs, decays = panel_grid(summary)
    ctrls = sorted({s["controller"] for s in summary})
    nrows, ncols = len(decays), len(fovs)
    fig, axes = plt.subplots(nrows, 2 * ncols,
                             figsize=(4.5 * 2 * ncols, 3.2 * nrows),
                             squeeze=False)
    for i, decay in enumerate(decays):
        for j, fov in enumerate(fovs):
            ax1, ax2 = axes[i][2 * j], axes[i][2 * j + 1]
            cell = [s for s in summary
                    if s["fov"] == fov and s["slack_decay"] == decay]
            for c in ctrls:
                pts = sorted([s for s in cell if s["controller"] == c],
                             key=lambda s: s["num_robots"])
                if not pts:
                    continue
                R = [s["num_robots"] for s in pts]
                ax1.plot(R, [s["success_rate"] for s in pts], "o-",
                         label=f"{c} (strict)")
                if all("success_ref_rate" in s for s in pts):
                    ax1.plot(R, [s["success_ref_rate"] for s in pts], "s--",
                             alpha=0.7, label=f"{c} (ref)")
                ax2.errorbar(R, [s["makespan_mean"] for s in pts],
                             yerr=[s["makespan_ci95"] for s in pts],
                             fmt="o-", capsize=3, label=c)
            tag = ", ".join(
                ([f"FOV {fov:g}°"] if fov is not None else [])
                + ([f"decay {decay:g}"] if decay is not None else []))
            ax1.set_title(f"success {('(' + tag + ')') if tag else ''}",
                          fontsize=9)
            ax2.set_title(f"makespan {('(' + tag + ')') if tag else ''}",
                          fontsize=9)
            ax1.set_xlabel("num robots"); ax1.set_ylabel("success rate")
            ax1.set_ylim(-0.05, 1.05); ax1.grid(alpha=0.3)
            ax1.legend(fontsize=8)
            # makespan is counted in replan STEPS (h-periods), not seconds
            ax2.set_xlabel("num robots"); ax2.set_ylabel("makespan [steps]")
            ax2.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=130, bbox_inches="tight")
    print(path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results", required=True, help="sweep JSONL file")
    p.add_argument("--plot", default=None)
    args = p.parse_args(argv)

    summary = aggregate(load_rows(args.results))
    hdr = (f"{'controller':>14} {'fov':>6} {'decay':>6} {'R':>3} {'n':>3} "
           f"{'strict':>8} {'ref':>6} {'makespan':>9} {'ci95':>7}")
    print(hdr)
    for s in summary:
        fov = f"{s['fov']:g}" if s["fov"] is not None else "-"
        dec = f"{s['slack_decay']:g}" if s["slack_decay"] is not None else "-"
        ref = (f"{s['success_ref_rate']:.2f}"
               if "success_ref_rate" in s else "-")
        print(f"{s['controller']:>14} {fov:>6} {dec:>6} {s['num_robots']:>3} "
              f"{s['n']:>3} {s['success_rate']:>8.2f} {ref:>6} "
              f"{s['makespan_mean']:>9.2f} {s['makespan_ci95']:>7.2f}")

    if args.plot:
        plot(summary, args.plot)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
